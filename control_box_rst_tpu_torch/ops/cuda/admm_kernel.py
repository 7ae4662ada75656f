"""Box-QP ADMM on the card: the hand-written CUDA kernels, their wrappers and
their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas/admm_kernel.py``:

  ``boxqp_solve``  ↔ ``boxqp_solve_pallas``  — the whole box-QP solve of every
      lane (recentered ρ-adaptive ADMM rounds with early exit) in one launch;
  ``admm_round``   ↔ ``admm_round_pallas``   — one ρ-round at fixed ρ.

The kernels are CUDA C++ (``csrc/admm_kernel.cu``, one thread per lane,
tile-major lane layout; see the source note there). They are compiled at first use
with ``nvcc`` for ``sm_90a`` into a shared library with a plain C interface
and loaded with ``ctypes``; nothing is built or looked up when this module is
imported.

Dispatch rule of both wrappers: a CPU tensor takes the plain version
(``boxqp_solve_plain`` / ``admm_round_plain``); a CUDA tensor launches the
kernel or raises — there is no fallback when the build or the launch fails.
``LAUNCHES`` counts kernel launches per wrapper, and nothing else.

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
from typing import Dict

import torch

from control_box_rst_tpu_torch.ops.btridiag import (
    btridiag_cholesky,
    btridiag_solve,
    interval_to_stage,
)
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

SOURCE = build.CSRC / "admm_kernel.cu"


def build_spec(nz: int, nc: int) -> build.Spec:
    """(source, defines) of the (nz, nc) specialisation, as
    ``ops/cuda/build.py`` takes it."""
    return SOURCE, {"NZ": nz, "NC": nc}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def admm_round_plain(
    Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
    iters: int, sigma: float, alpha: float, rho_eq_scale: float,
):
    """One ρ-round at fixed per-lane ρ: assemble M, factor, ``iters`` OSQP
    iterations with the dynamics z eliminated (z_d ≡ −c), pr/dr once on the
    final iterate (dr is the one-step-lookahead box step). The plain version
    of ``admm_round``. Returns (x, z_b, y_d, y_b, pr [...], dr [...])."""
    # per-row ρ: equality-like box rows (pins: dlb == dub) get ρ_eq
    rho_eq = (rho * rho_eq_scale)[..., None, None]  # broadcasts over [K, n]
    rho_box = torch.where(dlb == dub, rho_eq, rho[..., None, None]).to(Hd.dtype)
    D, O = assemble_M(Hd, J, K, sigma, rho_eq[..., None], rho_box)
    Ld, Lo = btridiag_cholesky(D, O)
    x_t = torch.zeros_like(x)
    for _ in range(iters):
        vd = -rho_eq * c - y_d
        rhs = (
            sigma * x - g
            + interval_to_stage(mv_small_t(J, vd), mv_small_t(K, vd))
            + (rho_box * z_b - y_b)
        )
        x_t = btridiag_solve(Ld, Lo, rhs)
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
# load (built at first use by ops/cuda/build.py)
# --------------------------------------------------------------------------

def _load(nz: int, nc: int) -> ctypes.CDLL:
    def declare(lib):
        c_f, c_i, c_p = ctypes.c_float, ctypes.c_int, ctypes.c_void_p
        for fn in (lib.admm_kernel_nz, lib.admm_kernel_nc):
            fn.restype, fn.argtypes = c_i, []
        lib.admm_round_launch.restype = c_i
        lib.admm_round_launch.argtypes = [
            c_p, ctypes.c_longlong, c_i, c_i, c_i, c_i, c_f, c_f, c_f, c_p,
        ]
        lib.boxqp_solve_launch.restype = c_i
        lib.boxqp_solve_launch.argtypes = [
            c_p, ctypes.c_longlong, c_i, c_i, c_i, c_i, c_i,
            c_f, c_f, c_f, c_f, c_f, c_f, c_f, c_f, c_p,
        ]
        if (lib.admm_kernel_nz(), lib.admm_kernel_nc()) != (nz, nc):
            raise RuntimeError(f"library built for another (nz, nc) than {(nz, nc)}")

    return build.load(*build_spec(nz, nc), declare)


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
    """The kernels take float32. Strides are free (a broadcast view is fine):
    the wrapper copies every operand into the kernels' own contiguous lane
    layout, and that copy is what the kernel sees."""
    for name, a in zip(_ARG_NAMES, args):
        if a.dtype != torch.float32:
            raise TypeError(f"{name}: the CUDA kernels take float32, got {a.dtype}")


def _lane_invariant(*arrays: torch.Tensor) -> bool:
    """True when every array is one copy broadcast over the batch (stride 0
    on dim 0, as ``expand`` makes it): the kernels then read a single shared
    copy instead of one per lane."""
    return all(a.stride(0) == 0 for a in arrays)


def _kernel_operands(args):
    """The 12 reference-order operands in the kernels' layout, and whether
    Hd, J, K are passed as one shared copy."""
    shared = _lane_invariant(*args[:3])
    head = (
        [a[0].reshape(-1).contiguous() for a in args[:3]] if shared
        else [to_kernel_layout(a) for a in args[:3]]
    )
    return head + [to_kernel_layout(a) for a in args[3:]], shared


def admm_round(
    Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
    iters: int, sigma: float, alpha: float, rho_eq_scale: float,
):
    """One ρ-round of the stage-QP ADMM for a batch of lanes (layout in the
    module docstring). Returns (x', z_b', y_d', y_b', pr [B], dr [B])."""
    args = (Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b)
    B, Kst, nz, nc = _check_args(args)
    if iters < 1:
        raise ValueError("iters must be >= 1")
    if Hd.device.type == "cpu":
        return admm_round_plain(*args, iters, sigma, alpha, rho_eq_scale)
    if Hd.device.type != "cuda":
        raise RuntimeError(f"admm_round: unsupported device {Hd.device}")
    _check_cuda_args(args)
    lib = _load(nz, nc)
    N, ntri = Kst - 1, nz * (nz + 1) // 2
    with torch.cuda.device(Hd.device):
        t, shared = _kernel_operands(args)
        new = lambda rows: torch.empty(
            (rows * padded_lanes(B),), dtype=torch.float32, device=Hd.device)
        Ld, Lo, xt = new(Kst * ntri), new(N * nz * nz), new(Kst * nz)
        pr, dr = (torch.empty((B,), dtype=torch.float32, device=Hd.device) for _ in range(2))
        ptrs = ptr_array(t + [Ld, Lo, xt, pr, dr])
        err = lib.admm_round_launch(
            ptrs, B, Kst, lane_tile(B), int(shared), int(iters), float(sigma),
            float(alpha),
            float(rho_eq_scale), torch.cuda.current_stream().cuda_stream,
        )
        LAUNCHES["admm_round"] += 1
    if err != 0:
        raise RuntimeError(f"admm_round_kernel launch failed: CUDA error {err}")
    return (
        from_kernel_layout(t[8], x.shape), from_kernel_layout(t[9], z_b.shape),
        from_kernel_layout(t[10], y_d.shape), from_kernel_layout(t[11], y_b.shape),
        pr, dr,
    )


def boxqp_solve(
    Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b,
    n_rounds: int, iters: int, tol: float, sigma: float, alpha: float,
    rho_eq_scale: float, rho_min: float, rho_max: float,
    tol_stat: float = 0.0, tol_feas: float = 0.0,
):
    """Full box-QP ADMM solve (all ρ rounds) for a batch of lanes in one
    kernel launch. Returns (x, z_b, y_d, y_b, pr [B], dr [B], it [B] float)."""
    args = (Hd, J, K, g, c, dlb, dub, rho, x, z_b, y_d, y_b)
    B, Kst, nz, nc = _check_args(args)
    if iters < 1 or n_rounds < 1:
        raise ValueError("iters and n_rounds must be >= 1")
    scal = (
        int(n_rounds), int(iters), float(tol), float(sigma), float(alpha),
        float(rho_eq_scale), float(rho_min), float(rho_max),
        float(tol_stat), float(tol_feas),
    )
    if Hd.device.type == "cpu":
        return boxqp_solve_plain(*args, *scal)
    if Hd.device.type != "cuda":
        raise RuntimeError(f"boxqp_solve: unsupported device {Hd.device}")
    _check_cuda_args(args)
    lib = _load(nz, nc)
    N, ntri = Kst - 1, nz * (nz + 1) // 2
    with torch.cuda.device(Hd.device):
        t, shared = _kernel_operands(args)  # g, c copies double as g_s, c_s
        new = lambda rows: torch.empty(
            (rows * padded_lanes(B),), dtype=torch.float32, device=Hd.device)
        Ld, Lo, xt = new(Kst * ntri), new(N * nz * nz), new(Kst * nz)
        pr, dr, it = (torch.empty((B,), dtype=torch.float32, device=Hd.device) for _ in range(3))
        xtot = torch.zeros_like(xt)
        ptrs = ptr_array(t + [Ld, Lo, xt, pr, dr, xtot, it])
        err = lib.boxqp_solve_launch(
            ptrs, B, Kst, lane_tile(B), int(shared), *scal,
            torch.cuda.current_stream().cuda_stream,
        )
        LAUNCHES["boxqp_solve"] += 1
    if err != 0:
        raise RuntimeError(f"boxqp_solve_kernel launch failed: CUDA error {err}")
    return (
        from_kernel_layout(xtot, x.shape), from_kernel_layout(t[9], z_b.shape),
        from_kernel_layout(t[10], y_d.shape), from_kernel_layout(t[11], y_b.shape),
        pr, dr, it,
    )
