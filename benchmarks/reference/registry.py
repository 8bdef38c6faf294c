"""Decorator-based name -> class registries.

The port's own registries (``rise_sdf_tpu/registry.py`` rejects
duplicate names, so the two packages cannot share one): components are
instantiated by ``make(name, config)`` under the same names as in the
JAX package, so one config drives either.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str):
        def decorator(cls):
            if name in self._items:
                raise KeyError(f"{self.kind} '{name}' already registered")
            self._items[name] = cls
            return cls

        return decorator

    def make(self, name: str, *args, **kwargs):
        if name not in self._items:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Available: {sorted(self._items)}"
            )
        return self._items[name](*args, **kwargs)

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self):
        return sorted(self._items)


models = Registry("model")
systems = Registry("system")
datasets = Registry("dataset")
