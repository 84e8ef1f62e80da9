"""Generic name -> class registry (counterpart of ``sgmse_tpu/utils/registry.py``).

Decorator-based registration, duplicate registration warns and replaces, lookup
by name, and enumeration of all registered names (used to build dynamic CLIs).
"""
from __future__ import annotations

import warnings
from typing import Callable, Dict, Iterable, TypeVar

T = TypeVar("T")


class Registry:
    """A tiny string-keyed registry used for backbones, SDEs, predictors and correctors."""

    def __init__(self, managed_thing: str):
        self.managed_thing = managed_thing
        self._registry: Dict[str, type] = {}

    def register(self, name: str) -> Callable[[T], T]:
        def inner(cls: T) -> T:
            if name in self._registry:
                warnings.warn(
                    f"{self.managed_thing} '{name}' doubly registered, old class will be replaced."
                )
            self._registry[name] = cls
            return cls

        return inner

    def get_by_name(self, name: str) -> type:
        if name not in self._registry:
            raise ValueError(
                f"{self.managed_thing} '{name}' unknown. Available: {sorted(self._registry)}"
            )
        return self._registry[name]

    def get_all_names(self) -> Iterable[str]:
        return list(self._registry.keys())

    def __contains__(self, name: str) -> bool:
        return name in self._registry
