"""ctypes binding of the repo's native C++ decode pipeline (``csrc/dataloader``),
the port's own copy of ``visiondk_tpu/data/native.py``.

``NativeDecoder`` decodes and resizes a whole batch of image files into one
pre-allocated uint8 NHWC array on a persistent C++ thread pool, with the GIL
released for the whole batch. It is host code, not a device kernel.

The library is built on first use with ``make -C csrc`` into the gitignored
``csrc/build/`` (it needs g++ and OpenCV's headers and libraries). Import
never fails: callers check ``native_available()`` and take the PIL path
when the library cannot be built or loaded; ``native_error()`` says why.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_REPO_ROOT = Path(__file__).resolve().parents[2]
_SO_PATH = _REPO_ROOT / "csrc" / "build" / "libvdk_loader.so"

_lib = None
_lib_error: Optional[str] = None


def _build():
    proc = subprocess.run(["make", "-C", str(_REPO_ROOT / "csrc")], capture_output=True, text=True, timeout=300)
    if proc.returncode:
        raise RuntimeError(f"make -C csrc failed: {(proc.stderr or proc.stdout).strip()[-300:]}")


def _load_lib():
    global _lib, _lib_error
    if _lib is not None or _lib_error is not None:
        return _lib
    try:
        if not _SO_PATH.is_file():
            _build()
        lib = ctypes.CDLL(str(_SO_PATH))
        if not hasattr(lib, "vdk_decode_batch_ops"):
            # stale build from before the per-sample-op entry: rebuild once.
            # Unlink first — g++ -o truncates in place, and dlopen dedupes by
            # inode, so rebuilding into the same inode would hand back the
            # already-loaded (stale) handle.
            _SO_PATH.unlink(missing_ok=True)
            _build()
            lib = ctypes.CDLL(str(_SO_PATH))
        lib.vdk_decode_batch_ops.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vdk_loader_create.restype = ctypes.c_void_p
        lib.vdk_loader_create.argtypes = [ctypes.c_int] * 4
        lib.vdk_loader_destroy.argtypes = [ctypes.c_void_p]
        lib.vdk_decode_batch.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vdk_decode_one.restype = ctypes.c_int
        lib.vdk_decode_one.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_int,
        ]
        _lib = lib
    except Exception as e:  # missing toolchain / headers → PIL fallback
        _lib_error = str(e)
        _lib = None
    return _lib


def native_available() -> bool:
    return _load_lib() is not None


def native_error() -> Optional[str]:
    """Why the library could not be built or loaded (None when it was)."""
    _load_lib()
    return _lib_error


class NativeDecoder:
    """Batch decode+resize(+letterbox) into uint8 [B, H, W, 3]."""

    def __init__(self, height: int, width: int, threads: int = 8, letterbox: bool = True):
        lib = _load_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_lib_error}")
        self._lib = lib
        self.height, self.width = height, width
        self._handle = lib.vdk_loader_create(height, width, threads, int(letterbox))

    def decode_batch(self, paths: Sequence[str], out: Optional[np.ndarray] = None
                     ) -> Tuple[np.ndarray, np.ndarray]:
        n = len(paths)
        if out is None:
            out = np.empty((n, self.height, self.width, 3), np.uint8)
        assert out.shape == (n, self.height, self.width, 3) and out.dtype == np.uint8
        ok = np.zeros((n,), np.uint8)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self._lib.vdk_decode_batch(
            self._handle,
            arr,
            n,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out, ok.astype(bool)

    def decode_batch_ops(self, paths: Sequence[str], ops: np.ndarray,
                         out: Optional[np.ndarray] = None
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """Decode with a per-sample geometry op (int32 [B, 5] rows of
        ``[mode, a, b, c, d]``): mode 0 letterbox, 1 crop rect
        (left, top, w, h) + resize, 2 plain resize. The randomized-train
        entry — the caller samples each crop from its reproducible
        per-sample RNG (transforms.RandomResizedCrop.sample_params)."""
        n = len(paths)
        ops = np.ascontiguousarray(ops, dtype=np.int32)
        assert ops.shape == (n, 5), ops.shape
        if out is None:
            out = np.empty((n, self.height, self.width, 3), np.uint8)
        assert out.shape == (n, self.height, self.width, 3) and out.dtype == np.uint8
        ok = np.zeros((n,), np.uint8)
        arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        self._lib.vdk_decode_batch_ops(
            self._handle,
            arr,
            n,
            ops.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        )
        return out, ok.astype(bool)

    def __del__(self):
        try:
            if getattr(self, "_handle", None):
                self._lib.vdk_loader_destroy(self._handle)
                self._handle = None
        except Exception:
            pass


def decode_one(path: str, height: int, width: int, letterbox: bool = True) -> np.ndarray:
    lib = _load_lib()
    if lib is None:
        raise RuntimeError(f"native loader unavailable: {_lib_error}")
    out = np.empty((height, width, 3), np.uint8)
    rc = lib.vdk_decode_one(
        os.fsencode(path),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        height, width, int(letterbox),
    )
    if rc != 0:
        raise OSError(f"decode failed: {path}")
    return out
