"""Generic name→factory registry (counterpart of ``visiondk_tpu/registry.py``).

Every subsystem (backbones first; losses, optimizers and schedulers as they are
ported) registers into its own ``Registry`` instance with a decorator or a
direct ``register(fn, name=...)`` call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable, Optional


class Registry:
    """A name → callable registry with decorator registration."""

    def __init__(self, name: str):
        self.name = name
        self._store: Dict[str, Callable] = {}

    def register(self, fn: Optional[Callable] = None, *, name: Optional[str] = None):
        """Use as ``@registry.register`` or ``@registry.register(name="alias")``."""

        def _do_register(f: Callable) -> Callable:
            key = name or f.__name__
            if key in self._store:
                raise ValueError(
                    f"{self.name}: an entry is already registered under the name {key!r}."
                )
            self._store[key] = f
            return f

        if fn is None:
            return _do_register
        return _do_register(fn)

    def get(self, key: str) -> Callable:
        key = key.strip()
        if key not in self._store:
            raise KeyError(
                f"{self.name}: unknown entry {key!r}. Available: {sorted(self._store)}"
            )
        return self._store[key]

    def create(self, key: str, *args: Any, **kwargs: Any) -> Any:
        return self.get(key)(*args, **kwargs)

    def __contains__(self, key: str) -> bool:
        return key in self._store

    def __iter__(self) -> Iterable[str]:
        return iter(self._store)

    def keys(self):
        return sorted(self._store)

    def items(self):
        return self._store.items()
