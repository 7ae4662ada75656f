"""Box-QP ADMM on the card: the hand-written CUDA kernels, their wrappers and
their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas/admm_kernel.py``:

  ``boxqp_solve``  ↔ ``boxqp_solve_pallas``  — the whole box-QP solve of every
      lane (recentered ρ-adaptive ADMM rounds with early exit) in one launch;
  ``admm_round``   ↔ ``admm_round_pallas``   — one ρ-round at fixed ρ.

The kernels are CUDA C++ (``csrc/admm_kernel.cu``; see the source note
there), two routes behind each wrapper. Where a lane's state fits shared
memory (``solve_route``: every horizon up to a few hundred stages) the
kernels keep it there for the whole solve, a team of threads serves a lane,
persistent blocks hand lanes out from a queue, and the operands are read and
the results written batch-first as the caller has them: the wrapper copies
nothing but a strided or broadcast view. Longer horizons take the
one-thread-per-lane kernels with the state in device memory and a tile-major
lane layout (``ops/cuda/layout.py``). The library is compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes``; nothing is built or looked up when this module is
imported.

Dispatch rule of both wrappers: a CPU tensor takes the plain version
(``boxqp_solve_plain`` / ``admm_round_plain``); a CUDA tensor launches a
kernel or raises — there is no fallback when the build or the launch fails,
and the route is chosen from the shapes, never from a failure.
``LAUNCHES`` counts kernel launches per wrapper, and nothing else;
``LAUNCHES_BY_SHAPE`` counts the same launches by (wrapper, nz, nc), one
count per build; ``LAUNCH_INFO`` says what the last launch of each wrapper
chose.

Per-lane QP (δ = step on the stage variables, Kst = N+1 stages):

  min  Σ ½ δ_kᵀ Hd_k δ_k + g_kᵀ δ_k
  s.t. J_k δ_k + K_k δ_{k+1} = −c_k ,   dlb_k ≤ δ_k ≤ dub_k

Argument layout, same as the reference: Hd [B,Kst,nz,nz], J/K [B,N,nc,nz],
g [B,Kst,nz], c [B,N,nc], dlb/dub [B,Kst,nz], rho [B], warm start x/z_b/y_b
[B,Kst,nz], y_d [B,N,nc]; float32.

Exit semantics differ from the TPU kernel on purpose: there a 1024-lane tile
leaves its round loop when all of its lanes have converged; here every lane
stops at its own convergence, as the per-lane reference does, and ``it`` is
the lane's own count.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Tuple

import torch

from control_box_rst_tpu_torch.ops.btridiag import (
    btridiag_cholesky,
    btridiag_solve,
    interval_to_stage,
)
from control_box_rst_tpu_torch.ops.btridiag_cr import bcr_factor, bcr_solve
from control_box_rst_tpu_torch.ops.cuda import build
from control_box_rst_tpu_torch.ops.cuda.layout import (
    from_kernel_layout,
    lane_tile,
    padded_lanes,
    ptr_array,
    to_kernel_layout,
)
from control_box_rst_tpu_torch.ops.smallmat import mm_small_tn, mv_small, mv_small_t

# kernel launches per wrapper (incremented where a kernel is launched, and
# nowhere else)
LAUNCHES: Dict[str, int] = {"boxqp_solve": 0, "admm_round": 0}
# the same launches by (wrapper, nz, nc): one count per build
LAUNCHES_BY_SHAPE: Dict[Tuple[str, int, int], int] = {}

SOURCE = build.CSRC / "admm_kernel.cu"


def build_spec(nz: int, nc: int) -> build.Spec:
    """(source, defines) of the (nz, nc) specialisation, as
    ``ops/cuda/build.py`` takes it."""
    return SOURCE, {"NZ": nz, "NC": nc}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAUNCHES_BY_SHAPE.clear()


def _count_launch(name: str, nz: int, nc: int) -> None:
    LAUNCHES[name] += 1
    key = (name, nz, nc)
    LAUNCHES_BY_SHAPE[key] = LAUNCHES_BY_SHAPE.get(key, 0) + 1


# --------------------------------------------------------------------------
# plain PyTorch versions (batch-first; any float dtype, any device)
# --------------------------------------------------------------------------

def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def assemble_M(Hd, J, K, sigma, rho_eq, rho_box):
    """Block-tridiagonal normal matrix of the box QP,
    M = Hd + σI + ρ_eq(JᵀJ at k, KᵀK at k+1, JᵀK off-diagonal) + diag(ρ_box).
    ``rho_eq`` is a float or broadcasts against [..., N, nz, nz]; ``rho_box``
    is [..., Kst, nz]. Returns (D [..., Kst, nz, nz], O [..., N, nz, nz])."""
    eye = torch.eye(Hd.shape[-1], dtype=Hd.dtype, device=Hd.device)
    JtJ = rho_eq * mm_small_tn(J, J)
    KtK = rho_eq * mm_small_tn(K, K)
    zero = torch.zeros_like(JtJ[..., :1, :, :])
    D = (
        Hd + sigma * eye
        + torch.cat([JtJ, zero], dim=-3)
        + torch.cat([zero, KtK], dim=-3)
        + torch.diag_embed(rho_box)
    )
    return D, rho_eq * mm_small_tn(J, K)


LINSOLVERS = ("scan", "bcr")


def factor_solver(D, O, linsolver: str = "scan"):
    """Factor the block-tridiagonal M = tridiag(Oᵀ, D, O) and return its
    solve ``rhs [..., K, nz] → x``: 'scan' the sequential block Cholesky
    (``ops/btridiag.py``, the kernels' recurrence), 'bcr' block cyclic
    reduction (``ops/btridiag_cr.py``)."""
    if linsolver == "scan":
        Ld, Lo = btridiag_cholesky(D, O)
        return lambda rhs: btridiag_solve(Ld, Lo, rhs)
    if linsolver == "bcr":
        fac = bcr_factor(D, O)
        return lambda rhs: bcr_solve(fac, rhs)
    raise KeyError(f"unknown linsolver {linsolver!r}; have {list(LINSOLVERS)}")


def admm_round_plain(
    Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
    iters: int, sigma: float, alpha: float, rho_eq_scale: float,
    linsolver: str = "scan",
):
    """One ρ-round at fixed per-lane ρ: assemble M, factor, ``iters`` OSQP
    iterations with the dynamics z eliminated (z_d ≡ −c), pr/dr once on the
    final iterate (dr is the one-step-lookahead box step). The plain version
    of ``admm_round`` (``linsolver`` 'scan', the kernel's; 'bcr' is the
    reference's other linear solver, which no kernel runs). Returns (x, z_b,
    y_d, y_b, pr [...], dr [...])."""
    # per-row ρ: equality-like box rows (pins: dlb == dub) get ρ_eq
    rho_eq = (rho * rho_eq_scale)[..., None, None]  # broadcasts over [K, n]
    rho_box = torch.where(dlb == dub, rho_eq, rho[..., None, None]).to(Hd.dtype)
    D, O = assemble_M(Hd, J, K, sigma, rho_eq[..., None], rho_box)
    solve_M = factor_solver(D, O, linsolver)
    x_t = torch.zeros_like(x)
    for _ in range(iters):
        vd = -rho_eq * c - y_d
        rhs = (
            sigma * x - g
            + interval_to_stage(mv_small_t(J, vd), mv_small_t(K, vd))
            + (rho_box * z_b - y_b)
        )
        x_t = solve_M(rhs)
        x = alpha * x_t + (1.0 - alpha) * x
        ax = mv_small(J, x_t[..., :-1, :]) + mv_small(K, x_t[..., 1:, :])
        v_d = alpha * ax + (1.0 - alpha) * (-c)
        y_d = y_d + rho_eq * (v_d + c)
        v_b = alpha * x_t + (1.0 - alpha) * z_b
        z_new = _clip(v_b + y_b / rho_box, dlb, dub)
        y_b = y_b + rho_box * (v_b - z_new)
        z_b = z_new
    ax = mv_small(J, x_t[..., :-1, :]) + mv_small(K, x_t[..., 1:, :])
    pr = torch.maximum(
        (ax + c).abs().amax(dim=(-2, -1)), (x_t - z_b).abs().amax(dim=(-2, -1))
    )
    v_b = alpha * x_t + (1.0 - alpha) * z_b
    z_new = _clip(v_b + y_b / rho_box, dlb, dub)
    dr = (rho_box * (z_new - z_b)).abs().amax(dim=(-2, -1))
    return x, z_b, y_d, y_b, pr, dr


def boxqp_solve_plain(
    Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
    n_rounds: int, iters: int, tol: float, sigma: float, alpha: float,
    rho_eq_scale: float, rho_min: float, rho_max: float,
    tol_stat: float = 0.0, tol_feas: float = 0.0,
):
    """The full box-QP solve, per-lane semantics: up to ``n_rounds`` rounds of
    {``admm_round_plain`` on the recentered data; recenter (g += H·x,
    c += A·x, bounds shift by xtot, x := 0); exit test; ρ rescale}. A lane
    leaves the loop at its own convergence — ADMM pr, dr < tol or, with both
    ``tol_stat`` and ``tol_feas`` > 0, the exact KKT residuals of the LTI QP
    below them — and is frozen from then on. The plain version of
    ``boxqp_solve``. Returns (xtot, z_b, y_d, y_b, pr, dr, it [...] float)."""
    use_kkt = tol_stat > 0.0 and tol_feas > 0.0
    lead = g.shape[:-2]
    dtype, dev = g.dtype, g.device
    # every carried array gets the full lane shape up front
    rho = rho.expand(lead).clone()
    x, z_b, y_b = (a.expand(lead + a.shape[-2:]) for a in (x, z_b, y_b))
    y_d = y_d.expand(lead + y_d.shape[-2:])
    xtot = torch.zeros_like(x)
    g_s, c_s = g, c
    pr = torch.full(lead, math.inf, dtype=dtype, device=dev)
    dr = torch.full(lead, math.inf, dtype=dtype, device=dev)
    it = torch.zeros(lead, dtype=torch.float32, device=dev)
    active = torch.ones(lead, dtype=torch.bool, device=dev)
    is_free = dlb != dub

    for _ in range(n_rounds):
        if not bool(active.any()):
            break
        x_n, zb_n, yd_n, yb_n, pr_n, dr_n = admm_round_plain(
            Hd, J, K, g_s, c_s, dlb - xtot, dub - xtot, rho, x, z_b, y_d, y_b,
            iters, sigma, alpha, rho_eq_scale,
        )
        # ---- recenter ----
        xtot_n = xtot + x_n
        cs_n = c_s + mv_small(J, x_n[..., :-1, :]) + mv_small(K, x_n[..., 1:, :])
        gs_n = g_s + mv_small(Hd, x_n)
        zb_n = _clip(torch.zeros_like(x_n), dlb - xtot_n, dub - xtot_n)
        x_n = torch.zeros_like(x_n)
        # ---- convergence ----
        conv = (pr_n < tol) & (dr_n < tol)
        if use_kkt:
            feas = cs_n.abs().amax(dim=(-2, -1))
            gl = gs_n + yb_n + interval_to_stage(mv_small_t(J, yd_n), mv_small_t(K, yd_n))
            stat = torch.where(is_free, gl.abs(), torch.zeros_like(gl)).amax(dim=(-2, -1))
            conv = conv | ((stat < tol_stat) & (feas < tol_feas))
        scale = torch.sqrt(pr_n / torch.clamp(dr_n, min=1e-30))
        rho_n = torch.clamp(rho * torch.clamp(scale, 0.1, 10.0), rho_min, rho_max)
        rho_n = torch.where(conv, rho, rho_n)
        # ---- per-lane freeze: only lanes still active take the round ----
        a2 = active[..., None, None]
        xtot = torch.where(a2, xtot_n, xtot)
        g_s = torch.where(a2, gs_n, g_s)
        c_s = torch.where(a2, cs_n, c_s)
        x = torch.where(a2, x_n, x)
        z_b = torch.where(a2, zb_n, z_b)
        y_d = torch.where(a2, yd_n, y_d)
        y_b = torch.where(a2, yb_n, y_b)
        rho = torch.where(active, rho_n, rho)
        pr = torch.where(active, pr_n, pr)
        dr = torch.where(active, dr_n, dr)
        it = torch.where(active, it + float(iters), it)
        active = active & ~conv
    return xtot, z_b, y_d, y_b, pr, dr, it


# --------------------------------------------------------------------------
# work counted from the loops of csrc/admm_kernel.cu (for roofline bounds)
# --------------------------------------------------------------------------

def round_flops(Kst: int, nz: int, nc: int, iters: int) -> int:
    """float32 operations of one ρ-round of one lane, counted from the loops
    of ``round_ops`` (a multiply-add counts 2, a divide / sqrt / max / compare
    counts 1)."""
    N = Kst - 1
    ntri = nz * (nz + 1) // 2
    # assemble D (lower): J'J and K'K terms 3 ops per (r, entry), diag 2
    asm = Kst * (2 * ntri * nc * 3 + 2 * nz)
    # X = L^-1 O: O entries (2nc) + rho_eq, substitution nz(nz-1) per column + div
    xsolve = N * nz * (nz * (2 * nc) + nz * (nz - 1) + nz)
    schur = N * ntri * 2 * nz
    chol = Kst * (nz ** 3 // 3 + 2 * nz)
    factor = asm + xsolve + schur + chol
    fwd = Kst * (nz * 5) + N * nc * (2 + 2 * nz) + N * nc * 2 * nz \
        + N * 2 * nz * nz + Kst * (nz * (nz - 1) + nz)
    bwd = N * 2 * nz * nz + Kst * (nz * (nz - 1) + nz)
    upd = N * nc * (4 * nz + 6) + Kst * nz * 14
    resid = N * nc * (4 * nz + 3) + Kst * nz * 13
    return factor + iters * (fwd + bwd + upd) + resid


def solve_flops_per_round(Kst: int, nz: int, nc: int, iters: int, use_kkt: bool) -> int:
    """As ``round_flops`` plus the recentering and exit test of the full solve."""
    N = Kst - 1
    recenter = N * nc * 4 * nz + Kst * nz * (2 * nz + 5)
    kkt = (N * nc * (2 + 4 * nz) + Kst * nz * 4) if use_kkt else 0
    return round_flops(Kst, nz, nc, iters) + recenter + kkt + 12


def io_bytes(Kst: int, nz: int, nc: int, B: int, full_solve: bool,
             shared_hjk: bool = False) -> int:
    """Bytes the function must move: every input read once, every output
    written once (float32). With ``shared_hjk`` Hd, J, K are one copy for
    the batch, not one per lane."""
    N = Kst - 1
    hjk = Kst * nz * nz + 2 * N * nc * nz
    inputs = Kst * nz + N * nc + 2 * Kst * nz + 1 + 3 * Kst * nz + N * nc
    outputs = 3 * Kst * nz + N * nc + (3 if full_solve else 2)
    return 4 * (B * (inputs + outputs) + (1 if shared_hjk else B) * hjk)


# --------------------------------------------------------------------------
# the two routes of the kernels, and the rule that picks one from the shapes
# --------------------------------------------------------------------------

# Dynamic shared memory one block may ask for on an H100 (227 KB).
MAX_DYNAMIC_SMEM_BYTES = 232448
# The shared-memory route is taken where at least this many lanes fit a block.
MIN_RESIDENT_LANES = 4
# Lanes served by one warp on the shared-memory route: teams of 16 threads
# (``TEAM`` of ``csrc/admm_kernel.cu``, a compile-time constant).
LANES_PER_WARP = 2
SMEM_ALIGN_FLOATS = 4
ROUTES = ("smem", "thread")

# what the last launch of each wrapper chose (route, block shape, registers)
LAUNCH_INFO: Dict[str, dict] = {"boxqp_solve": {}, "admm_round": {}}


def _round_up(floats: int) -> int:
    return -(-floats // SMEM_ALIGN_FLOATS) * SMEM_ALIGN_FLOATS


def state_bytes_per_lane(Kst: int, nz: int, nc: int, shared_hjk: bool) -> int:
    """Shared memory one lane takes on the shared-memory route: the sum of
    the table ``SMEM_LANE_ARRAYS`` of ``csrc/admm_kernel.cu`` — eight stage
    vectors, two interval vectors, per stage one record of the diagonal
    factor (packed lower) with the reciprocals of its pivots, the
    sub-diagonal factors, and the lane's own J and K unless Hd, J, K are one
    copy for the batch — every array rounded up to 16 bytes."""
    N = Kst - 1
    record = _round_up(nz * (nz + 1) // 2 + nz)
    floats = (
        8 * _round_up(Kst * nz) + 2 * _round_up(N * nc)
        + _round_up(Kst * record) + _round_up(N * nz * nz)
    )
    if not shared_hjk:
        floats += 2 * _round_up(N * nc * nz)
    return 4 * floats


def solve_route(Kst: int, nz: int, nc: int, shared_hjk: bool) -> str:
    """Which kernels a problem shape takes, from the shape alone: ``'smem'``
    (a lane's state in shared memory, a team of threads per lane) where at
    least ``MIN_RESIDENT_LANES`` lanes fit the shared memory of a block,
    ``'thread'`` (one thread per lane, state in device memory) otherwise —
    long horizons."""
    fits = MIN_RESIDENT_LANES * state_bytes_per_lane(Kst, nz, nc, shared_hjk)
    return "smem" if fits <= MAX_DYNAMIC_SMEM_BYTES else "thread"


def resident_lanes_per_sm(Kst: int, nz: int, nc: int, shared_hjk: bool) -> int:
    """Lanes the shared memory of one SM holds on the shared-memory route, in
    whole warps of ``LANES_PER_WARP`` lanes (what the launcher reaches at the
    flagship shapes; ``LAUNCH_INFO`` has what a launch really got)."""
    warp_bytes = LANES_PER_WARP * state_bytes_per_lane(Kst, nz, nc, shared_hjk)
    return LANES_PER_WARP * (MAX_DYNAMIC_SMEM_BYTES // warp_bytes)


# --------------------------------------------------------------------------
# load (built at first use by ops/cuda/build.py)
# --------------------------------------------------------------------------

def declare(lib: ctypes.CDLL, nz: int, nc: int) -> None:
    """``restype`` / ``argtypes`` of the library's C functions, and a check
    that it is the (nz, nc) specialisation."""
    c_f, c_i, c_p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
    c_ll = ctypes.c_longlong
    for fn in (lib.admm_kernel_nz, lib.admm_kernel_nc):
        fn.restype, fn.argtypes = c_i, []
    lib.admm_smem_floats_per_lane.restype = c_i
    lib.admm_smem_floats_per_lane.argtypes = [c_i, c_i]
    lib.admm_round_launch.restype = c_i
    lib.admm_round_launch.argtypes = [c_p, c_ll, c_i, c_i, c_i, c_i, c_f, c_f, c_f, c_p]
    lib.boxqp_solve_launch.restype = c_i
    lib.boxqp_solve_launch.argtypes = [c_p, c_ll, c_i, c_i, c_i, c_i, c_i] + [c_f] * 8 + [c_p]
    lib.admm_round_smem_launch.restype = c_i
    lib.admm_round_smem_launch.argtypes = [c_p, c_ll, c_i, c_i, c_i, c_f, c_f, c_f, c_p, c_p]
    lib.boxqp_solve_smem_launch.restype = c_i
    lib.boxqp_solve_smem_launch.argtypes = (
        [c_p, c_ll, c_i, c_i, c_i, c_i] + [c_f] * 8 + [c_p, c_p])
    lib.admm_division_check_launch.restype = c_i
    lib.admm_division_check_launch.argtypes = [c_p, c_p, c_p, c_ll, c_p]
    if (lib.admm_kernel_nz(), lib.admm_kernel_nc()) != (nz, nc):
        raise RuntimeError(f"library built for another (nz, nc) than {(nz, nc)}")


def _load(nz: int, nc: int) -> ctypes.CDLL:
    return build.load(*build_spec(nz, nc), lambda lib: declare(lib, nz, nc))


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

_ARG_NAMES = ("Hd", "J", "K", "g", "c", "dlb", "dub", "rho", "x", "z_b", "y_d", "y_b")


def _check_args(args):
    """Shapes, dtype and device of the 12 reference-order operands; raises on
    anything the kernels do not take."""
    Hd = args[0]
    if Hd.dim() != 4 or Hd.shape[-1] != Hd.shape[-2]:
        raise ValueError(f"Hd must be [B, Kst, nz, nz], got {tuple(Hd.shape)}")
    B, Kst, nz, _ = Hd.shape
    J = args[1]
    if J.dim() != 4 or J.shape[0] != B or J.shape[1] != Kst - 1 or J.shape[3] != nz:
        raise ValueError(f"J must be [B, Kst-1, nc, nz], got {tuple(J.shape)}")
    N, nc = Kst - 1, J.shape[2]
    if Kst < 2:
        raise ValueError("need at least two stages")
    want = {
        "Hd": (B, Kst, nz, nz), "J": (B, N, nc, nz), "K": (B, N, nc, nz),
        "g": (B, Kst, nz), "c": (B, N, nc), "dlb": (B, Kst, nz),
        "dub": (B, Kst, nz), "rho": (B,), "x": (B, Kst, nz),
        "z_b": (B, Kst, nz), "y_d": (B, N, nc), "y_b": (B, Kst, nz),
    }
    for name, a in zip(_ARG_NAMES, args):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(a.shape)}")
        if a.device != Hd.device:
            raise ValueError(f"{name} is on {a.device}, Hd on {Hd.device}")
        if a.dtype != Hd.dtype:
            raise ValueError(f"{name} is {a.dtype}, Hd is {Hd.dtype}")
    return B, Kst, nz, nc


def _check_cuda_args(args):
    """The kernels take float32. Strides are free (a broadcast or strided
    view is fine): the wrappers make a contiguous copy of what is not
    contiguous, and only of that."""
    for name, a in zip(_ARG_NAMES, args):
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {a.dtype}")


def _lane_invariant(*arrays: torch.Tensor) -> bool:
    """True when every array is one copy broadcast over the batch (stride 0
    on dim 0, as ``expand`` makes it): the kernels then read a single shared
    copy instead of one per lane."""
    return all(a.stride(0) == 0 for a in arrays)


def _kernel_operands(args):
    """The 12 reference-order operands in the tile-major lane layout of the
    one-thread-per-lane kernels, and whether Hd, J, K are passed as one
    shared copy."""
    shared = _lane_invariant(*args[:3])
    head = (
        [a[0].reshape(-1).contiguous() for a in args[:3]] if shared
        else [to_kernel_layout(a) for a in args[:3]]
    )
    return head + [to_kernel_layout(a) for a in args[3:]], shared


def _batch_first_operands(args):
    """The 12 reference-order operands as the shared-memory kernels read
    them: batch-first and contiguous. An operand that is contiguous already
    is passed as it is (no copy); Hd, J, K broadcast over the batch are
    passed as their one copy."""
    shared = _lane_invariant(*args[:3])
    head = [a[0].contiguous() if shared else a.contiguous() for a in args[:3]]
    return head + [a.contiguous() for a in args[3:]], shared


def _pick_route(name, route, Kst, nz, nc, shared):
    rule = solve_route(Kst, nz, nc, shared)
    if route is None:
        return rule
    if route not in ROUTES:
        raise ValueError(f"{name}: route must be one of {ROUTES} or None, got {route!r}")
    if route == "smem" and rule != "smem":
        raise ValueError(
            f"{name}: a lane of Kst={Kst}, nz={nz}, nc={nc} takes "
            f"{state_bytes_per_lane(Kst, nz, nc, shared)} bytes; fewer than "
            f"{MIN_RESIDENT_LANES} fit {MAX_DYNAMIC_SMEM_BYTES} bytes of shared memory")
    return route


def _launch_smem(lib, name, args, dims, scal, stream):
    """Launch a shared-memory-route kernel on batch-first operands (no layout
    conversion; outputs allocated batch-first). ``name``: 'boxqp_solve' or
    'admm_round'. Returns the outputs in the wrappers' order."""
    B, Kst, nz, nc = dims
    t, shared = _batch_first_operands(args)
    want = state_bytes_per_lane(Kst, nz, nc, shared)
    have = 4 * lib.admm_smem_floats_per_lane(Kst, int(shared))
    if have != want:
        raise RuntimeError(
            f"{name}: the kernel carves {have} bytes of shared memory per lane, "
            f"state_bytes_per_lane says {want}")
    x, z_b, y_d, y_b = (torch.empty_like(t[i]) for i in (8, 9, 10, 11))
    full = name == "boxqp_solve"
    pr, dr, it = (torch.empty_like(t[7]) for _ in range(3))
    outs = [x, z_b, y_d, y_b, pr, dr]
    if full:
        outs += [it, torch.zeros((1,), dtype=torch.int32, device=x.device)]
    info = (ctypes.c_int * 6)()
    launch = lib.boxqp_solve_smem_launch if full else lib.admm_round_smem_launch
    err = launch(ptr_array(t + outs), B, Kst, int(shared), *scal, info, stream)
    _count_launch(name, nz, nc)
    if err != 0:
        raise RuntimeError(f"{name}: shared-memory kernel launch failed: CUDA error {err}")
    LAUNCH_INFO[name] = dict(
        route="smem", lanes_per_warp=LANES_PER_WARP, shared_hjk=bool(shared),
        smem_bytes_per_lane=want, warps_per_block=info[0], smem_bytes_per_block=info[1],
        blocks=info[2], blocks_per_sm=info[3], registers_per_thread=info[4], sms=info[5],
        resident_lanes_per_sm=info[3] * info[0] * LANES_PER_WARP,
    )
    return (x, z_b, y_d, y_b, pr, dr, it) if full else (x, z_b, y_d, y_b, pr, dr)


def _launch_thread(lib, name, args, dims, scal, stream):
    """Launch a one-thread-per-lane kernel: operands converted into the
    tile-major lane layout, scratch allocated, results converted back."""
    B, Kst, nz, nc = dims
    N, ntri = Kst - 1, nz * (nz + 1) // 2
    x_in = args[8]
    t, shared = _kernel_operands(args)  # g, c copies double as g_s, c_s
    new = lambda rows: torch.empty(
        (rows * padded_lanes(B),), dtype=torch.float32, device=x_in.device)
    Ld, Lo, xt = new(Kst * ntri), new(N * nz * nz), new(Kst * nz)
    full = name == "boxqp_solve"
    pr, dr, it = (torch.empty((B,), dtype=torch.float32, device=x_in.device) for _ in range(3))
    extra = [Ld, Lo, xt, pr, dr]
    if full:
        xtot = torch.zeros_like(xt)
        extra += [xtot, it]
    launch = lib.boxqp_solve_launch if full else lib.admm_round_launch
    err = launch(ptr_array(t + extra), B, Kst, lane_tile(B), int(shared), *scal, stream)
    _count_launch(name, nz, nc)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err}")
    LAUNCH_INFO[name] = dict(route="thread", lane_tile=lane_tile(B), shared_hjk=bool(shared))
    back = lambda i, like: from_kernel_layout(t[i], like.shape)
    tail = (back(9, args[9]), back(10, args[10]), back(11, args[11]), pr, dr)
    if full:
        return (from_kernel_layout(xtot, x_in.shape),) + tail + (it,)
    return (back(8, x_in),) + tail


def _launch(name, args, dims, scal, route):
    Hd = args[0]
    if Hd.device.type != "cuda":
        raise RuntimeError(f"{name}: unsupported device {Hd.device}")
    _check_cuda_args(args)
    _, Kst, nz, nc = dims
    route = _pick_route(name, route, Kst, nz, nc, _lane_invariant(*args[:3]))
    lib = _load(nz, nc)
    with torch.cuda.device(Hd.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "smem":
            return _launch_smem(lib, name, args, dims, scal, stream)
        return _launch_thread(lib, name, args, dims, scal, stream)


def division_mismatches(a: torch.Tensor, b: torch.Tensor, nz: int, nc: int) -> torch.Tensor:
    """Where the shared-memory kernels' quotient (``quotient`` of
    ``csrc/quotient.cuh``: a / b from the reciprocal of b, with its
    fallback) and the division differ in a bit: int32 [n], 1 = differs. A
    check for the card (``chip_smoke.py``); float32 CUDA vectors only."""
    if a.device.type != "cuda" or a.dtype != torch.float32 or a.shape != b.shape or a.dim() != 1:
        raise ValueError("division_mismatches takes two float32 CUDA vectors of one length")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty(a.shape, dtype=torch.int32, device=a.device)
    lib = _load(nz, nc)
    with torch.cuda.device(a.device):
        err = lib.admm_division_check_launch(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"division check launch failed: CUDA error {err}")
    return out


def admm_round(
    Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
    iters: int, sigma: float, alpha: float, rho_eq_scale: float,
    route=None,
):
    """One ρ-round of the stage-QP ADMM for a batch of lanes (layout in the
    module docstring). Returns (x', z_b', y_d', y_b', pr [B], dr [B]).
    ``route``: None (the shape rule ``solve_route``); ``'smem'`` / ``'thread'``
    name a kernel, for checks and measurements."""
    args = (Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b)
    dims = _check_args(args)
    if iters < 1:
        raise ValueError("iters must be >= 1")
    scal = (int(iters), float(sigma), float(alpha), float(rho_eq_scale))
    if Hd.device.type == "cpu":
        return admm_round_plain(*args, *scal)
    return _launch("admm_round", args, dims, scal, route)


def boxqp_solve(
    Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
    n_rounds: int, iters: int, tol: float, sigma: float, alpha: float,
    rho_eq_scale: float, rho_min: float, rho_max: float,
    tol_stat: float = 0.0, tol_feas: float = 0.0,
    route=None,
):
    """Full box-QP ADMM solve (all ρ rounds) for a batch of lanes in one
    kernel launch. Returns (x, z_b, y_d, y_b, pr [B], dr [B], it [B] float).
    ``route``: None (the shape rule ``solve_route``); ``'smem'`` / ``'thread'``
    name a kernel, for checks and measurements."""
    args = (Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b)
    dims = _check_args(args)
    if iters < 1 or n_rounds < 1:
        raise ValueError("iters and n_rounds must be >= 1")
    scal = (
        int(n_rounds), int(iters), float(tol), float(sigma), float(alpha),
        float(rho_eq_scale), float(rho_min), float(rho_max),
        float(tol_stat), float(tol_feas),
    )
    if Hd.device.type == "cpu":
        return boxqp_solve_plain(*args, *scal)
    return _launch("boxqp_solve", args, dims, scal, route)
