"""String-keyed component registry.

Counterpart of the JAX package's ``core/factory.py``: a name → constructor
registry per category ("system", "integrator"), which the config loader
(``core/config.py``) resolves YAML ``type:`` keys through. The registry is
this package's own: the two packages loaded in one process never share
registrations.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable


class Factory:
    """Registry of this package: category → name → constructor."""

    _registries: Dict[str, Dict[str, Callable[..., Any]]] = {}

    @classmethod
    def register(cls, category: str, name: str, ctor: Callable[..., Any]) -> None:
        cls._registries.setdefault(category, {})[name] = ctor

    @classmethod
    def create(cls, category: str, name: str, /, **kwargs: Any) -> Any:
        return cls.get(category, name)(**kwargs)

    @classmethod
    def get(cls, category: str, name: str) -> Callable[..., Any]:
        """The constructor registered under ``name`` (KeyError if none)."""
        reg = cls._registries.get(category, {})
        if name not in reg:
            raise KeyError(
                f"unknown {category} {name!r}; registered: {sorted(reg)}"
            )
        return reg[name]

    @classmethod
    def names(cls, category: str) -> Iterable[str]:
        return sorted(cls._registries.get(category, {}))

    @classmethod
    def has(cls, category: str, name: str) -> bool:
        return name in cls._registries.get(category, {})


def register(category: str, name: str | None = None):
    """Decorator form: ``@register("system", "van_der_pol")``."""

    def deco(ctor):
        Factory.register(category, name or ctor.__name__, ctor)
        return ctor

    return deco


create = Factory.create
