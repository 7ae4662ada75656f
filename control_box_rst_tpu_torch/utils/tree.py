"""Plain dataclass helpers.

Counterpart of the JAX package's ``utils/tree.py``. There, every configurable
object is a frozen dataclass registered as a pytree; here it is a frozen
dataclass and nothing more: tensors are ordinary fields, structural fields
are ordinary fields, and ``replace`` is ``dataclasses.replace``.
``tree_to`` takes the place of ``jax.tree.map`` for the one use the port has
for it: moving every tensor of a nested object to a device / dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Any, TypeVar

import torch

_T = TypeVar("_T")


def plain_dataclass(cls: type[_T]) -> type[_T]:
    """Decorator: frozen dataclass with a ``replace`` method. ``eq=False``:
    fields hold tensors, so instances compare and hash by identity."""
    c = dataclasses.dataclass(frozen=True, eq=False)(cls)
    if not hasattr(c, "replace"):
        def _replace(self, **changes):
            return dataclasses.replace(self, **changes)
        c.replace = _replace  # type: ignore[attr-defined]
    return c


def tree_to(obj: Any, device=None, dtype=None) -> Any:
    """Move every tensor inside ``obj`` (dataclasses and tuples, nested) to
    ``device``; floating-point tensors are also cast to ``dtype``. Everything
    that is not a tensor is returned as it is."""
    if isinstance(obj, torch.Tensor):
        if dtype is not None and obj.is_floating_point():
            return obj.to(device=device, dtype=dtype)
        return obj.to(device=device)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {
            f.name: tree_to(getattr(obj, f.name), device, dtype)
            for f in dataclasses.fields(obj)
            if f.init
        }
        return dataclasses.replace(obj, **changes)
    if isinstance(obj, tuple):
        return tuple(tree_to(o, device, dtype) for o in obj)
    return obj
