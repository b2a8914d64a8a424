"""Host data loaders and the device feeder (counterpart of ``visiondk_tpu/data/loader.py``).

- ``DataLoader``: multi-threaded decode/augment workers with a bounded
  prefetch; epoch-seeded shuffling (``set_epoch``), per-process index
  sharding, ``drop_last`` for train, and the last eval batch padded to a
  static shape with its real row count in ``'valid'``. Threads, not
  processes: PIL decode and most numpy work release the GIL, and a batch
  is a plain numpy dict, so nothing is pickled.
- ``NativeTrainLoader`` / ``NativeEvalLoader``: the same contracts over the
  C++ decode pool (``data/native.py``) when the pipeline allows it.
- ``DevicePrefetcher``: moves batch N+1 to the card while step N runs.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch


def _stack_labels(labels: List[Any]) -> np.ndarray:
    first = labels[0]
    if isinstance(first, (int, np.integer)):
        return np.asarray(labels, dtype=np.int32)
    return np.stack([np.asarray(l, dtype=np.float32) for l in labels])


class DataLoader:
    """Iterable over dict batches {'image': [B,H,W,3] uint8, 'label': ...}.

    - ``shuffle``: epoch-seeded permutation (call ``set_epoch``).
    - ``drop_last``: True for train (static batch).
    - eval: last partial batch is padded by repeating row 0; ``'valid'`` holds
      the real count.
    - ``process_index/process_count``: multi-host sharding of the index space
      (DistributedSampler parity).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        shuffle: bool = False,
        drop_last: bool = False,
        num_workers: int = 8,
        prefetch: int = 4,
        seed: int = 0,
        process_index: int = 0,
        process_count: int = 1,
        collate: Optional[Callable] = None,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.seed = seed
        self.epoch = 0
        self.process_index = process_index
        self.process_count = process_count
        self.collate = collate or self._default_collate

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    @staticmethod
    def _default_collate(samples: List[Any]) -> Dict[str, np.ndarray]:
        images, labels = zip(*samples)
        return {
            "image": np.stack([np.asarray(im) for im in images]),
            "label": _stack_labels(list(labels)),
        }

    def _indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(n)
        else:
            idx = np.arange(n)
        # shard across hosts, padding so every host sees the same #batches
        if self.process_count > 1:
            per = -(-n // self.process_count)
            padded = np.resize(idx, per * self.process_count)
            idx = padded[self.process_index :: self.process_count]
        return idx

    def __len__(self) -> int:
        n = len(self._indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        indices = self._indices()
        n_batches = len(self)
        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    pending = []
                    for b in range(n_batches):
                        batch_idx = indices[b * self.batch_size : (b + 1) * self.batch_size]
                        fut = pool.submit(self._make_batch, batch_idx)
                        pending.append(fut)
                        # bounded pipeline: emit in order
                        while len(pending) >= self.prefetch or (
                            b == n_batches - 1 and pending
                        ):
                            if stop.is_set():
                                return
                            out_q.put(pending.pop(0).result())
                out_q.put(None)
            except BaseException as e:  # a failed sample surfaces in the consumer
                out_q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()

    def pad_batch(self, batch: Dict[str, np.ndarray], valid: int) -> Dict[str, np.ndarray]:
        if valid < self.batch_size:
            pad = self.batch_size - valid
            batch = {
                k: np.concatenate([v, np.repeat(v[:1], pad, axis=0)], axis=0)
                for k, v in batch.items()
            }
        batch["valid"] = np.asarray(valid, np.int32)
        return batch

    def _make_batch(self, batch_idx: np.ndarray) -> Dict[str, np.ndarray]:
        from visiondk_tpu_torch.data.transforms import seed_sample

        samples = []
        for i in batch_idx:
            # reproducible augmentation per (seed, epoch, sample) regardless
            # of worker-thread scheduling
            seed_sample(self.seed, self.epoch, int(i))
            samples.append(self.dataset[int(i)])
        batch = self.collate(samples)
        # pad final eval batch to static shape
        return self.pad_batch(batch, len(samples))


class NativeTrainLoader:
    """Train loader over file paths using the C++ decode pool
    (csrc/dataloader): once the device-augment split leaves the host stage as
    plain letterbox, a single RandomResizedCrop, or a RandomChoice over
    letterbox/RandomResizedCrop branches of one size — the reference
    pet.yaml geometry block — (transforms.native_train_stage), the WHOLE
    host pipeline is one GIL-free native call per batch. For the randomized
    stages each sample's branch + crop rect are drawn host-side from the
    same per-(seed, epoch, sample) stream the PIL path uses
    (transforms.sample_native_geometry, fed by header-only image dims cached
    across epochs) and executed by the pool — identical geometry, C++
    decode+crop+resize. Resample kernels differ on downscale: the native
    crop path uses cv::INTER_AREA where the PIL path uses Image.BILINEAR
    (geometry — branch choice + crop rect — is identical; pixel values are
    not bit-equal, so a mid-training PIL fallback epoch shifts the pixel
    distribution slightly; see docs/PARITY.md "Known intentional
    differences").

    DataLoader-contract parity: epoch-seeded shuffle (``set_epoch``),
    drop_last static batches, multi-host index sharding, background prefetch.
    The stage is re-read from the live dataset pipeline at each ``__iter__``
    (progressive resize / warmup hot-swaps rebuild the pipeline); if the
    pipeline stops being native-eligible for an epoch, that epoch falls back
    to the PIL DataLoader transparently.
    """

    shuffle = True

    def __init__(
        self,
        dataset,
        batch_size: int,
        seed: int = 0,
        num_workers: int = 8,
        prefetch: int = 4,
        process_index: int = 0,
        process_count: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.epoch = 0
        self.num_workers = max(num_workers, 1)
        self.prefetch = prefetch
        self.process_index = process_index
        self.process_count = process_count
        self._decoder = None
        self._decoder_size = None
        self._dims: Dict[str, tuple] = {}  # path → header (w, h), RRC stage
        self._fallback = DataLoader(
            dataset, batch_size, shuffle=True, drop_last=True,
            num_workers=num_workers, prefetch=prefetch, seed=seed,
            process_index=process_index, process_count=process_count,
        )

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        self._fallback.set_epoch(epoch)

    def _indices(self) -> np.ndarray:
        return DataLoader._indices(self)  # same shuffle/shard contract

    def __len__(self) -> int:
        return len(self._indices()) // self.batch_size

    def _current_stage(self):
        from visiondk_tpu_torch.data.transforms import native_train_stage

        base = getattr(self.dataset.transforms, "base_transforms", self.dataset.transforms)
        if getattr(self.dataset.transforms, "class_transforms", None):
            return None
        return native_train_stage(base)

    def _dims_of(self, path: str) -> tuple:
        """Header-only (w, h) read, cached across epochs. (0, 0) on failure —
        the native decode of that file will then also fail and the corrupt
        -row substitution below covers it."""
        d = self._dims.get(path)
        if d is None:
            try:
                from PIL import Image

                with Image.open(path) as im:
                    d = im.size
            except Exception:
                d = (0, 0)
            self._dims[path] = d
        return d

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        stage = self._current_stage()
        if stage is None:
            yield from self._fallback
            return
        kind, arg = stage
        if kind == "letterbox":
            size = arg
        elif kind == "choice":
            size = next(iter(arg.transforms)).size  # common size (validated)
        else:
            size = arg.size
        if self._decoder is None or self._decoder_size != size:
            from visiondk_tpu_torch.data.native import NativeDecoder

            self._decoder = NativeDecoder(size, size, threads=self.num_workers)
            self._decoder_size = size

        indices = self._indices()
        n_batches = len(self)
        ds = self.dataset
        label_tf = getattr(ds, "label_transforms", None)

        def make_batch(b: int) -> Dict[str, np.ndarray]:
            from visiondk_tpu_torch.data.transforms import sample_native_geometry, seed_sample

            batch_idx = indices[b * self.batch_size : (b + 1) * self.batch_size]
            paths = [ds.images[int(i)] for i in batch_idx]
            labels = [ds.labels[int(i)] for i in batch_idx]
            if kind in ("rrc", "choice"):
                # branch + crop rect from the SAME per-sample stream the PIL
                # path seeds (DataLoader._make_batch) — identical geometry
                ops = np.zeros((len(paths), 5), np.int32)
                for j, i in enumerate(batch_idx):
                    w, h = self._dims_of(paths[j])
                    if w > 0 and h > 0:
                        seed_sample(self.seed, self.epoch, int(i))
                        ops[j] = sample_native_geometry(arg, w, h)
                images, ok = self._decoder.decode_batch_ops(paths, ops)
            else:
                images, ok = self._decoder.decode_batch(paths)
            if not ok.all():
                good = np.flatnonzero(ok)
                if good.size == 0:
                    raise OSError(f"native decode failed for a whole batch: {paths[:3]}...")
                # corrupt-image substitution (DataLoader retries a random
                # index; here: replace with a valid row, image AND label)
                for bad in np.flatnonzero(~ok):
                    src = int(good[bad % good.size])
                    images[bad] = images[src]
                    labels[bad] = labels[src]
            if label_tf is not None:
                labels = [label_tf(l) for l in labels]
            return {"image": images, "label": _stack_labels(labels)}

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                for b in range(n_batches):
                    if stop.is_set():
                        return
                    out_q.put(make_batch(b))
                out_q.put(None)
            except BaseException as e:  # surface decode errors in the consumer
                out_q.put(e)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()


class NativeEvalLoader:
    """Deterministic eval/extraction loader over file paths using the C++
    decode pipeline (csrc/dataloader): decode+letterbox a whole batch in one
    GIL-free native call. Yields {'image': uint8 [B,H,W,3], 'keys': [...],
    'valid': n} — the same contract as DataLoader with a keys-collate.

    Use when the val pipeline is plain letterbox (transforms.is_plain_
    letterbox) and samples are file paths; otherwise fall back to DataLoader.
    """

    def __init__(
        self,
        paths: List[str],
        keys: List[Any],
        size: int,
        batch_size: int,
        threads: int = 8,
        letterbox: bool = True,
    ):
        from visiondk_tpu_torch.data.native import NativeDecoder

        self.paths = list(paths)
        self.keys = list(keys)
        self.batch_size = batch_size
        self.decoder = NativeDecoder(size, size, threads=threads, letterbox=letterbox)

    def __len__(self) -> int:
        return -(-len(self.paths) // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        bs = self.batch_size
        for b in range(len(self)):
            paths = self.paths[b * bs : (b + 1) * bs]
            keys = self.keys[b * bs : (b + 1) * bs]
            valid = len(paths)
            if valid < bs:  # pad to static shape
                paths = paths + [paths[-1]] * (bs - valid)
            images, _ = self.decoder.decode_batch(paths)
            yield {"image": images, "keys": keys, "valid": np.asarray(valid, np.int32)}


def loader_kind(loader) -> str:
    """Which decode path a loader built by ``SmartDataProcessor.dataloader``
    takes: ``"native"`` (the C++ pool) or ``"PIL"``. A ``NativeTrainLoader``
    falls back to PIL for an epoch whose pipeline the pool cannot run, so
    its kind is read at the epoch's start."""
    if isinstance(loader, NativeTrainLoader):
        return "native" if loader._current_stage() is not None else "PIL"
    return "native" if getattr(loader, "native", False) else "PIL"


class DevicePrefetcher:
    """Bounded look-ahead device feeder: the host→device copy of batch N+1
    overlaps step N.

    A feeder thread takes host batches (dicts of numpy arrays) from
    ``loader``. On a CUDA device it copies each array into pinned host
    memory and from there to the card with ``non_blocking=True`` on a side
    stream, and records an event on that stream. Before the consumer (the
    train loop, on its current stream) gets the batch, its stream waits on
    the event, and every device tensor is ``record_stream``-ed on the
    consumer's stream: the caching allocator then does not give the tensor's
    memory back to the side stream while the step may still read it. The
    pinned source is not reused under the copy either: PyTorch's host
    allocator records the copy's event on a pinned block and reuses it only
    once the event has passed. On the CPU a batch becomes tensors that share
    the arrays' memory, with no stream.

    ``depth`` bounds the look-ahead: a slot is taken before a batch is
    transferred and returned when the consumer takes it, so at most
    ``depth`` batches are on the card (or on their way) beyond the one the
    consumer holds. An exception in the loader or in the transfer surfaces
    on the consuming thread; a consumer that stops early stops the feeder,
    which finishes at most the one transfer in flight.
    """

    def __init__(self, loader, device, depth: int = 2):
        self.loader = loader
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.depth = max(int(depth), 1)

    def _transfer(self, batch: Dict[str, Any], stream) -> tuple:
        tensors = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}
        if stream is None:
            return tensors, None
        with torch.cuda.stream(stream):
            out = {k: t.pin_memory().to(self.device, non_blocking=True) if torch.is_tensor(t) else t
                   for k, t in tensors.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        cuda = self.device.type == "cuda"
        stream = torch.cuda.Stream(device=self.device) if cuda else None
        q: "queue.Queue" = queue.Queue()
        slots = threading.Semaphore(self.depth)
        sentinel = object()
        err: List[BaseException] = []
        stop = threading.Event()

        def feed() -> None:
            try:
                if cuda:
                    torch.cuda.set_device(self.device)
                for b in self.loader:
                    slots.acquire()
                    if stop.is_set():  # consumer bailed: skip remaining work
                        return
                    q.put(self._transfer(b, stream))
            except BaseException as e:  # surfaced on the consumer thread
                err.append(e)
            finally:
                q.put(sentinel)

        t = threading.Thread(target=feed, name="device-prefetch", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is sentinel:
                    break
                batch, event = item
                if event is not None:
                    consumer = torch.cuda.current_stream(self.device)
                    consumer.wait_event(event)
                    for v in batch.values():
                        if torch.is_tensor(v):
                            v.record_stream(consumer)
                slots.release()
                yield batch
        finally:
            # unblock a feeder parked on a slot, then drain until it exits
            stop.set()
            slots.release()
            while t.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    t.join(timeout=0.1)
        t.join()
        if err:
            raise err[0]
