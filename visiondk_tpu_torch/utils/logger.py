"""Dual-channel (console/file) logger (counterpart of ``visiondk_tpu/utils/logger.py``).

One instance per filename (a singleton), with ``console`` / ``log`` /
``both`` channels; dict messages are rendered as YAML (PyYAML is imported
only for those). The console channel prints to the current ``sys.stdout``,
so a redirected stdout sees it too. ``SmartLogger(console=False)`` with no
file is silent: the logger of a rank other than 0 in a distributed run.
"""

from __future__ import annotations

import logging
from typing import Any, Optional


class SmartLogger:
    _instances = {}

    def __new__(cls, filename: Optional[str] = None, console: bool = True):
        key = (filename or "<console>", console)
        if key not in cls._instances:
            cls._instances[key] = super().__new__(cls)
            cls._instances[key]._initialized = False
        return cls._instances[key]

    def __init__(self, filename: Optional[str] = None, console: bool = True):
        if self._initialized:
            return
        self._initialized = True
        self.filename = filename
        self._console = console

        self._file = None
        if filename is not None:
            self._file = logging.getLogger(f"visiondk_torch.file.{id(self)}")
            self._file.setLevel(logging.INFO)
            self._file.propagate = False
            fh = logging.FileHandler(filename)
            fh.setFormatter(logging.Formatter("%(asctime)s | %(message)s"))
            self._file.addHandler(fh)

    @staticmethod
    def _render(msg: Any) -> str:
        if isinstance(msg, dict):
            from visiondk_tpu_torch.config.loader import _yaml

            return _yaml().safe_dump(msg, sort_keys=False).rstrip()
        return str(msg)

    def console(self, *msgs: Any) -> None:
        if self._console:
            for m in msgs:
                print(self._render(m), flush=True)

    def log(self, *msgs: Any) -> None:
        if self._file is not None:
            for m in msgs:
                self._file.info(self._render(m))

    def both(self, *msgs: Any) -> None:
        self.console(*msgs)
        self.log(*msgs)
