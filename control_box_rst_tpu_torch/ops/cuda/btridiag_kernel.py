"""Block-tridiagonal SPD factor-and-solve on the card: the hand-written CUDA
kernels, their wrapper and their plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/btridiag_kernel.py``
(``btridiag_solve_pallas``: three sweeps, factor in scratch) and
``ops/pallas/btridiag_kernel_v2.py`` (``btridiag_solve_pallas_v2``: two
sweeps, factor written over D and O). One function,

  ``btridiag_factor_solve(D, O, b, inplace=True)``  →  x = M⁻¹ b,
  M = tridiag(Oᵀ, D, O),  D [B, K, nz, nz], O [B, K-1, nz, nz], b [B, K, nz],

with two kernels behind it (``csrc/btridiag_kernel.cu``, one thread per lane,
tile-major lane layout; see the source note there): ``inplace=True`` launches
the two-sweep kernel, ``inplace=False`` the three-sweep one. "In place" is the
kernel's business: the wrapper copies D and O into the kernels' lane layout
anyway and hands the kernel those copies, so the caller's tensors are never
written.

Dispatch rule: a CPU tensor takes the plain version
(``btridiag_factor_solve_plain``, the Python-loop recurrences of
``ops/btridiag.py``); a CUDA tensor launches the kernel or raises — there is
no fallback when the build or the launch fails. ``LAUNCHES`` counts kernel
launches per kernel, and nothing else. A block that is not positive definite
gives NaN in its lane, as the reference's square root does.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from control_box_rst_tpu_torch.ops.btridiag import btridiag_cholesky, btridiag_solve
from control_box_rst_tpu_torch.ops.cuda import build
from control_box_rst_tpu_torch.ops.cuda.layout import (
    from_kernel_layout,
    lane_tile,
    padded_lanes,
    ptr_array,
    to_kernel_layout,
)

# kernel launches per kernel (incremented where a kernel is launched, and
# nowhere else)
LAUNCHES: Dict[str, int] = {"btridiag_factor_solve": 0, "btridiag_factor_solve_inplace": 0}

SOURCE = build.CSRC / "btridiag_kernel.cu"


def build_spec(nz: int) -> build.Spec:
    """(source, defines) of the nz specialisation, as ``ops/cuda/build.py``
    takes it."""
    return SOURCE, {"NZ": nz}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def btridiag_factor_solve_plain(D, O, b):
    """x = M⁻¹ b by the block recurrences of ``ops/btridiag.py``: the plain
    version of both kernels (any float dtype, any device, any leading dims)."""
    return btridiag_solve(*btridiag_cholesky(D, O), b)


# --------------------------------------------------------------------------
# work counted from the loops of csrc/btridiag_kernel.cu (for roofline bounds)
# --------------------------------------------------------------------------

def factor_solve_flops(K: int, nz: int) -> int:
    """float32 operations of one lane, the same for both kernels (a
    multiply-subtract counts 2, a divide or a square root 1)."""
    chol = sum(2 * j + 2 + (nz - 1 - j) * (2 * j + 1) for j in range(nz))
    tri_vec = nz * nz                      # Σ_i (2i + 1)
    x_solve = nz * tri_vec                 # L X = O, nz columns
    schur = nz * (nz + 1) // 2 * 2 * nz    # S -= XᵀX, lower triangle
    coupling = 2 * nz * nz                 # Lo z  /  Loᵀ x
    per_stage = chol + 2 * tri_vec
    per_interval = x_solve + schur + 2 * coupling
    return K * per_stage + (K - 1) * per_interval


def io_bytes(K: int, nz: int, B: int) -> int:
    """Bytes the function must move: D, O, b read once, x written once
    (float32)."""
    return 4 * B * (K * nz * nz + (K - 1) * nz * nz + 2 * K * nz)


# --------------------------------------------------------------------------
# load (built at first use by ops/cuda/build.py)
# --------------------------------------------------------------------------

def _load(nz: int) -> ctypes.CDLL:
    def declare(lib):
        c_i, c_p = ctypes.c_int, ctypes.c_void_p
        lib.btridiag_kernel_nz.restype, lib.btridiag_kernel_nz.argtypes = c_i, []
        for fn in (lib.btridiag_factor_solve_launch,
                   lib.btridiag_factor_solve_inplace_launch):
            fn.restype = c_i
            fn.argtypes = [c_p, ctypes.c_longlong, c_i, c_i, c_p]
        if lib.btridiag_kernel_nz() != nz:
            raise RuntimeError(f"library built for another nz than {nz}")

    return build.load(*build_spec(nz), declare)


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------

def _check_args(D, O, b):
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"D must be [B, K, nz, nz], got {tuple(D.shape)}")
    B, K, nz, _ = D.shape
    if K < 1:
        raise ValueError("need at least one stage")
    want = {"O": (B, K - 1, nz, nz), "b": (B, K, nz)}
    for name, a in (("O", O), ("b", b)):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(a.shape)}")
        if a.device != D.device:
            raise ValueError(f"{name} is on {a.device}, D on {D.device}")
        if a.dtype != D.dtype:
            raise ValueError(f"{name} is {a.dtype}, D is {D.dtype}")
    return B, K, nz


def btridiag_factor_solve(D, O, b, inplace: bool = True):
    """Solve M x = b for a batch of SPD block-tridiagonal M = tridiag(Oᵀ, D, O):
    factor, forward sweep and backward sweep in one kernel launch.

    D [B, K, nz, nz] (only the lower triangle of each block is read),
    O [B, K-1, nz, nz], b [B, K, nz] → x [B, K, nz]. Any strides are taken,
    D and O broadcast over B included. ``inplace`` selects the two-sweep
    kernel that overwrites its copies of D and O with the factor (the
    default, what the solvers call) or the three-sweep kernel that keeps the
    factor in scratch; both give the same x. Float32 only on the card."""
    B, K, nz = _check_args(D, O, b)
    if D.device.type == "cpu":
        return btridiag_factor_solve_plain(D, O, b)
    if D.device.type != "cuda":
        raise RuntimeError(f"btridiag_factor_solve: unsupported device {D.device}")
    if D.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {D.dtype}")
    lib = _load(nz)
    with torch.cuda.device(D.device):
        Dl, Ol, bl = (to_kernel_layout(a) for a in (D, O, b))
        new = lambda rows: torch.empty(
            (rows * padded_lanes(B),), dtype=torch.float32, device=D.device)
        xl = new(K * nz)
        stream = torch.cuda.current_stream().cuda_stream
        if inplace:
            name = "btridiag_factor_solve_inplace"
            err = lib.btridiag_factor_solve_inplace_launch(
                ptr_array([Dl, Ol, bl, xl]), B, K, lane_tile(B), stream)
        else:
            name = "btridiag_factor_solve"
            scratch = [new(K * nz * (nz + 1) // 2), new((K - 1) * nz * nz), new(K * nz)]
            err = lib.btridiag_factor_solve_launch(
                ptr_array([Dl, Ol, bl, xl] + scratch), B, K, lane_tile(B), stream)
        LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}_kernel launch failed: CUDA error {err}")
    return from_kernel_layout(xl, b.shape)
