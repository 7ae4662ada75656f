"""Stage preprocessor: per-stage quantities shared by costs and constraints.

Counterpart of the JAX package's ``ocp/preprocessor.py``. A
``StagePreprocessor`` computes a quantity q = pre(x, u, dt) that several
stage terms use; ``PreprocessedStageCost`` and
``PreprocessedStageConstraint`` wrap user callables

    pre(x, u, dt)                  -> q   (any tensor or tuple of tensors)
    term(q, x, u, dt, xref, uref)  -> value

and plug into the ``StageCost`` / ``StageConstraint`` slots of
``ocp.transcribe``. Operands broadcast over leading dims as everywhere in the
port; a cost term returns [...] (a trailing dim of one is dropped), a
constraint term [..., n] (or [...] for one row). The reference's role of
saving recomputation is not played here: each term calls ``pre`` itself.
"""
from __future__ import annotations

from typing import Callable

import torch

from control_box_rst_tpu_torch.ocp.constraints import StageConstraint, as_rows, no_rows
from control_box_rst_tpu_torch.ocp.costs import StageCost
from control_box_rst_tpu_torch.utils.tree import plain_dataclass


def _as_value(v, like: torch.Tensor) -> torch.Tensor:
    """A cost term's value as [...] (the leading dims of ``like``)."""
    if not isinstance(v, torch.Tensor):
        v = torch.as_tensor(v, device=like.device)
    v = v.to(like.dtype)
    return v[..., 0] if v.dim() == like.dim() else v


@plain_dataclass
class StagePreprocessor:
    """Shared per-stage computation: ``fn(x, u, dt)``, or a subclass's
    ``precompute``."""

    fn: Callable = None

    def precompute(self, x, u, dt):
        if self.fn is None:
            return ()
        return self.fn(x, u, dt)


@plain_dataclass
class PreprocessedStageCost(StageCost):
    """stage(x, u, dt) = term(pre(x, u, dt), x, u, dt, xref, uref);
    final(x) = final_term(pre(x, 0, 0), x, xref)."""

    pre: StagePreprocessor = None
    term: Callable = None
    final_term: Callable = None  # (q, x, xref) -> value

    def stage(self, x, u, dt, xref, uref):
        if self.term is None:
            return torch.zeros_like(x[..., 0])
        q = self.pre.precompute(x, u, dt)
        return _as_value(self.term(q, x, u, dt, xref, uref), x)

    def final(self, x, xref):
        if self.final_term is None:
            return torch.zeros_like(x[..., 0])
        zero = torch.zeros_like(x[..., 0])
        q = self.pre.precompute(x, zero, zero)
        return _as_value(self.final_term(q, x, xref), x)


@plain_dataclass
class PreprocessedStageConstraint(StageConstraint):
    """Stage constraints over the same preprocessed quantity; ``neq`` /
    ``nineq`` are the row counts of ``eq_term`` / ``ineq_term``."""

    pre: StagePreprocessor = None
    eq_term: Callable = None  # (q, x, u, dt) -> [..., neq]
    ineq_term: Callable = None  # (q, x, u, dt) -> [..., nineq]

    def eq(self, x, u, dt, xref, uref):
        if self.eq_term is None:
            return no_rows(x)
        return as_rows(self.eq_term(self.pre.precompute(x, u, dt), x, u, dt), x)

    def ineq(self, x, u, dt, xref, uref):
        if self.ineq_term is None:
            return no_rows(x)
        return as_rows(self.ineq_term(self.pre.precompute(x, u, dt), x, u, dt), x)
