"""Precision and device policy of the port.

Counterpart of the JAX package's ``utils/precision.py`` (``f32_matmuls``).
The solver's linear algebra is small-matrix (4×4 Cholesky factors, ADMM
iterations with ρ_eq = 10³ρ): reduced-precision matrix products make the
iteration diverge. PyTorch's float32 products are full float32 unless TF32
is allowed, so the policy is:

  - float32 is the production dtype; float64 is allowed for tests and the
    oracle path; nothing else is accepted;
  - ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` are set when this module is
    imported (the package ``__init__`` imports it) and are asserted by
    ``check_precision_policy``;
  - ``resolve_device(None)`` means the card: it raises when there is none.
    No entry point silently runs on the CPU; tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

PRODUCTION_DTYPE = torch.float32
ALLOWED_DTYPES = (torch.float32, torch.float64)


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


disable_tf32()


def check_precision_policy() -> None:
    """Raise if something switched TF32 back on since import."""
    if torch.backends.cuda.matmul.allow_tf32 or torch.backends.cudnn.allow_tf32:
        raise RuntimeError(
            "TF32 is enabled; the solver needs full float32 products "
            "(call utils.precision.disable_tf32())"
        )


def resolve_dtype(dtype=None) -> torch.dtype:
    if dtype is None:
        return PRODUCTION_DTYPE
    if dtype not in ALLOWED_DTYPES:
        raise ValueError(f"dtype {dtype} not supported; have {ALLOWED_DTYPES}")
    return dtype


def resolve_device(device=None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); anything else is taken
    at its word, so ``"cpu"`` has to be asked for explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present: the port's entry points run on the "
                "card unless device='cpu' is passed explicitly"
            )
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device present")
    return device
