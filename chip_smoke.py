#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Drives the port's two main paths on the card — the config-1 batched MPC solve
by SQP (H=50 double integrator, B=32768 lanes, float32) through
``make_batched_solver``, and the same batch by Levenberg-Marquardt through
``make_batched_lm_solver`` — after building every CUDA kernel of those paths
from the sources in this checkout and holding each kernel against its plain
PyTorch version on the same inputs. There is no CPU path: without a CUDA
device the script exits non-zero and prints no result. Any phase that fails
raises, and the run fails with it.

Phases
  1 device   require CUDA; card name and power limit (nvidia-smi)
  2 build    compile csrc/*.cu with nvcc, one process per source, started
             together (seconds)
  3 kernels  box-QP ADMM kernels vs plain version at flagship shapes (Kst=51,
             nz=4, nc=2): 256 lanes of well-conditioned random QPs against the
             stated tolerances, 256 lanes of config-1 QPs built by the port
             against the float64 plain version, then the main path's batch for
             the production exits, the warm-started round of the outer SQP
             iteration, times and roofline bounds.
             Block-tridiagonal factor-and-solve kernels (three sweeps; two
             sweeps in place) vs plain version at K=51, nz=4, B=32768: random
             SPD systems (atol 5e-6), the damped Gauss-Newton systems of LM's
             first and of a late iteration on the config-1 batch (as close to
             the float64 plain version as the float32 plain version), B=1 and
             a batch not divisible by 32, the two kernels against each other,
             times, bounds and the dense library call as a yardstick
  4 main     the batched SQP solve; gates: converged fraction >= 0.99, max
             |U - U_oracle| <= 1e-3 on the first 64 lanes (f64 oracle golden
             file), kernel launch counter > 0; solves/s, mean SQP iterations,
             peak device memory, p99 of 50 single solves
  5 lm       the batched LM solve through the in-place kernel; gates:
             converged fraction >= 0.99, launch counter > 0, and on the first
             64 lanes U and chi2 as close to the f64 LM golden file as the
             reference's own float32 LM (stored in that file); then the same
             batch through the three-sweep kernel, which must give the same U
  6 result   one JSON line with every kernel's record, then the contract line

Output: progress lines, then a ``{"main": ...}`` line, a ``{"lm": ...}`` line,
the nvidia-smi line, a ``{"kernels": [...]}`` line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

GOLDEN = ROOT / "tests" / "golden" / "torch_flagship_oracle_N50.npz"
LM_GOLDEN = ROOT / "tests" / "golden" / "torch_lm_oracle_N50.npz"
BATCH = 32768      # lanes of the main paths
SMALL_BATCH = 256  # lanes of the tolerance checks
KERNEL_REPS = 3    # launches per kernel timing
TRIALS, REPS = 3, 2  # SQP path: best of TRIALS windows of REPS solves
LM_TRIALS = 2      # LM path: best of LM_TRIALS single batches
LM_LATE_ITERATION = 15  # the "late" LM iteration whose linear system is checked
CONV_GATE = 0.99
ERR_GATE = 1e-3
# published peaks of one H100 SXM (NVIDIA data sheet): the roofline yardstick
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_PER_S = 67e12
# kernel-vs-plain tolerances of a fixed-work round: float32 roundoff of two
# orderings of the same recurrences, amplified by rho_eq = 1e3 in the duals
# (the bounds the JAX package uses for its kernel vs its XLA path)
X_TOL = dict(rtol=2e-4, atol=2e-5)
DUAL_TOL = dict(rtol=2e-3, atol=3e-3)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls, CUDA events, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def assert_close(name, got, want, rtol, atol):
    err = (got - want).abs()
    bound = atol + rtol * want.abs()
    if not bool((err <= bound).all()) or not bool(torch.isfinite(got).all()):
        worst = float((err - bound).max())
        raise AssertionError(
            f"{name}: kernel and plain version disagree (max abs err "
            f"{float(err.max()):.3e}, worst excess over bound {worst:.3e}, "
            f"rtol={rtol}, atol={atol})"
        )
    return float(err.max())


def config1_qps(ocp, x0s, step=None, y_d=None, y_b=None):
    """The stage QPs of an SQP linearization of config 1 for a batch of
    initial states, in the kernels' argument order: the first one from a cold
    start, or, given ``step`` (the previous QP's solution) and its duals, the
    one the outer SQP loop builds next, warm-started from those duals."""
    from control_box_rst_tpu_torch.ocp.problem import Trajectory

    dtype, dev = x0s.dtype, x0s.device
    B = x0s.shape[0]
    N, nz, nc = ocp.N, ocp.nz, ocp.nc
    o = ocp.replace(bc=ocp.bc.replace(x0=x0s))
    traj0 = o.apply_boundary(
        Trajectory.linear_interp(x0s, o.refs.xref[-1], N, o.nu, 0.1)
    )
    W0 = o.pack(traj0)
    free = 1.0 - o.fixed_mask().to(dtype)
    if step is not None:
        W0 = W0 + step * free
    lb, ub = o.w_bounds()
    lb, ub = torch.clamp(lb, min=-1e8), torch.clamp(ub, max=1e8)
    W_ref = torch.zeros_like(W0[0])
    W_ref[:, o.nx:] = o.pack(traj0)[0, :, o.nx:]
    J, K, _ = o.interval_jacobians(W_ref)
    Hd = o.cost_hessian_blocks(W_ref) * free[:, None, :] * free[:, :, None]
    zero = torch.zeros_like(W0)
    ex = lambda a: a.expand((B,) + tuple(a.shape))
    dlb = torch.where(free > 0, lb - W0, zero)
    dub = torch.where(free > 0, ub - W0, zero)
    return [
        ex(Hd), ex(J * free[:-1, None, :]), ex(K * free[1:, None, :]),
        o.cost_gradient(W0) * free, o.interval_residuals(W0), dlb, dub,
        torch.ones(B, dtype=dtype, device=dev),  # rho of the flagship config
        zero, torch.minimum(torch.maximum(zero, dlb), dub),
        y_d if y_d is not None else torch.zeros((B, N, nc), dtype=dtype, device=dev),
        y_b if y_b is not None else zero,
    ]


def random_qps(B, Kst, nz, nc, rho, device):
    """Well-conditioned random box QPs at the kernels' shapes (the QPs of the
    JAX package's own kernel test, batched), made from a seed with numpy."""
    rng = np.random.default_rng(0)
    N = Kst - 1
    A = rng.standard_normal((B, Kst, nz, nz)) * 0.3
    Hd = np.einsum("bkij,bklj->bkil", A, A) + 2.0 * np.eye(nz)
    g = rng.standard_normal((B, Kst, nz))
    J = rng.standard_normal((B, N, nc, nz)) * 0.5
    K = rng.standard_normal((B, N, nc, nz)) * 0.5
    c = rng.standard_normal((B, N, nc)) * 0.1
    dlb = np.full((B, Kst, nz), -0.7)
    dub = np.full((B, Kst, nz), 0.7)
    dlb[:, 0, :2] = dub[:, 0, :2] = 0.0  # pins, like the fixed x0
    dlb[:, -1, -1] = dub[:, -1, -1] = 0.0
    z = np.zeros((B, Kst, nz))
    arrs = [Hd, J, K, g, c, dlb, dub, np.full((B,), rho), z,
            np.clip(z, dlb, dub), np.zeros((B, N, nc)), z]
    return [torch.as_tensor(a, dtype=torch.float32, device=device) for a in arrs]


def as_f64(args):
    return [a.double() for a in args]


def assert_as_close_as_plain(name, kern, plain, truth, slack=2.0, floor=1e-5):
    """The kernel may be as far from the float64 result as the float32 plain
    version is (times `slack`, plus `floor`), and no farther."""
    e_k = float((kern.double() - truth).abs().max())
    e_p = float((plain.double() - truth).abs().max())
    if not (e_k <= slack * e_p + floor) or not bool(torch.isfinite(kern).all()):
        raise AssertionError(
            f"{name}: kernel is {e_k:.3e} from the float64 plain version, the "
            f"float32 plain version {e_p:.3e} (allowed {slack} x + {floor})"
        )
    return e_k, e_p


def phase_kernels(ocp, cfg, x0s_all, small_b: int, reps: int):
    """Each kernel against its plain version; returns the kernels' records.

    Two kinds of inputs at the flagship shapes. On well-conditioned random QPs
    kernel and float32 plain version must agree within X_TOL / DUAL_TOL. On
    the config-1 QPs themselves M = Hd + sigma I + rho_eq A'A is ill-
    conditioned (rho_eq J'J ~ 1e3 * (1/dt)^2 against R = 0.2), so ONE
    non-recentered float32 round carries ~1e-3 of amplified roundoff whatever
    the order of operations: there the yardstick is the float64 plain version,
    and the kernel must be as close to it as the float32 plain version is.
    """
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak

    qp = cfg.qp
    base = dict(sigma=qp.sigma, alpha=qp.alpha, rho_eq_scale=qp.rho_eq_scale)
    solve_kw = dict(base, rho_min=qp.rho_min, rho_max=qp.rho_max)
    iters = qp.iters_per_round
    n_rounds = max(1, -(-(cfg.max_iter * qp.max_iter) // iters))
    prod_kw = dict(
        solve_kw, n_rounds=n_rounds, iters=iters, tol=qp.tol,
        tol_stat=cfg.tol_stat, tol_feas=cfg.tol_feas,
    )
    fixed_kw = dict(solve_kw, n_rounds=4, iters=iters, tol=0.0)
    x5 = {k: 5 * v for k, v in X_TOL.items()}
    d5 = {k: 5 * v for k, v in DUAL_TOL.items()}
    Kst, nz, nc = ocp.N + 1, ocp.nz, ocp.nc
    errs = {}

    # ---- random QPs, 256 lanes: kernel vs float32 plain version ----
    args = random_qps(small_b, Kst, nz, nc, 0.1, x0s_all.device)
    for it_n in (1, iters):
        out_k = ak.admm_round(*args, iters=it_n, **base)
        out_p = ak.admm_round_plain(*args, iters=it_n, **base)
        torch.cuda.synchronize()
        e = assert_close(f"admm_round iters={it_n} x", out_k[0], out_p[0], **X_TOL)
        assert_close(f"admm_round iters={it_n} z_b", out_k[1], out_p[1], **X_TOL)
        assert_close(f"admm_round iters={it_n} y_d", out_k[2], out_p[2], **DUAL_TOL)
        assert_close(f"admm_round iters={it_n} y_b", out_k[3], out_p[3], **DUAL_TOL)
        assert_close(f"admm_round iters={it_n} pr", out_k[4], out_p[4], rtol=1e-2, atol=1e-4)
        errs[f"random/admm_round_iters{it_n}_x"] = e
    # full solve, exits disabled: 4 rounds of fixed work, bounds loosened x5
    # (four rounds of adapted rho compound the roundoff of one)
    out_k = ak.boxqp_solve(*args, **fixed_kw)
    out_p = ak.boxqp_solve_plain(*args, **fixed_kw)
    torch.cuda.synchronize()
    errs["random/boxqp_solve_fixed4_x"] = assert_close(
        "boxqp_solve fixed x", out_k[0], out_p[0], **x5)
    assert_close("boxqp_solve fixed y_d", out_k[2], out_p[2], **d5)
    assert_close("boxqp_solve fixed y_b", out_k[3], out_p[3], **d5)
    if not bool((out_k[6] == 4 * iters).all()):
        raise AssertionError("boxqp_solve with exits disabled must run every round")
    # batches smaller than a warp take the kernels' other layout instance
    # (each lane contiguous); a lane's arithmetic is the same, so are its bits
    out_8 = ak.boxqp_solve(*[a[:8] for a in args], **fixed_kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b[:8]) for a, b in zip(out_8, out_k)):
        raise AssertionError("boxqp_solve: the small-batch layout disagrees with the warp-tile layout")

    # ---- config-1 QPs, 256 lanes: float64 plain version as the yardstick ----
    args = config1_qps(ocp, x0s_all[:small_b])
    for it_n in (1, iters):
        out_k = ak.admm_round(*args, iters=it_n, **base)
        out_p = ak.admm_round_plain(*args, iters=it_n, **base)
        out_d = ak.admm_round_plain(*as_f64(args), iters=it_n, **base)
        torch.cuda.synchronize()
        for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
            e_k, e_p = assert_as_close_as_plain(
                f"config1 admm_round iters={it_n} {nm}", out_k[i], out_p[i], out_d[i])
            errs[f"config1/admm_round_iters{it_n}_{nm}"] = [e_k, e_p]
    out_k = ak.boxqp_solve(*args, **fixed_kw)
    out_p = ak.boxqp_solve_plain(*args, **fixed_kw)
    out_d = ak.boxqp_solve_plain(*as_f64(args), **fixed_kw)
    torch.cuda.synchronize()
    for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
        # after 4 recentered rounds both float32 versions sit at their noise
        # level (~1e-5); a ratio of two noise-level numbers says little, so
        # the floor is 1e-4 here
        e_k, e_p = assert_as_close_as_plain(
            f"config1 boxqp_solve fixed {nm}", out_k[i], out_p[i], out_d[i], floor=1e-4)
        errs[f"config1/boxqp_solve_fixed4_{nm}"] = [e_k, e_p]
    # Hd, J, K of config 1 are broadcast views, which the kernels read as one
    # shared copy; one copy per lane must give the same bits
    out_c = ak.boxqp_solve(*[a.contiguous() for a in args], **fixed_kw)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out_k, out_c)):
        raise AssertionError("boxqp_solve: shared and per-lane Hd/J/K disagree")
    log(f"kernels[{small_b} lanes]: " + json.dumps(errs))

    # ---- the main path's batch: production exits, times, bounds ----
    # The exit tests compare float32 residuals at their noise floor with the
    # tolerances, so a lane near a threshold at a round boundary leaves one
    # round earlier or later depending on rounding (FMA contraction in the
    # kernel, none in the plain version). Gates: every lane within one round
    # of the plain version, at least 90 % on the same round, and the kernel's
    # solution as close to a tight float64 solve as the plain version's.
    B = x0s_all.shape[0]
    args = config1_qps(ocp, x0s_all)
    records = []

    out_k = ak.boxqp_solve(*args, **prod_kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = ak.boxqp_solve_plain(*args, **prod_kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    tight = dict(prod_kw, n_rounds=40, tol=1e-9, tol_stat=1e-9, tol_feas=1e-10)
    truth = ak.boxqp_solve_plain(*as_f64(args), **tight)[0]
    e_k, e_p = assert_as_close_as_plain(
        f"boxqp_solve B={B} production exits x", out_k[0], out_p[0], truth, slack=1.5, floor=1e-4)
    dx = float((out_k[0] - out_p[0]).abs().max())
    d_rounds = (out_k[6] - out_p[6]).abs() / iters
    same_it = float((d_rounds == 0).float().mean())
    if not bool((d_rounds <= 1).all()) or same_it < 0.90:
        raise AssertionError(
            f"boxqp_solve B={B}: per-lane rounds differ from the plain version "
            f"by up to {float(d_rounds.max())}, equal on {same_it:.4f} of lanes"
        )
    if not (dx <= 3e-3):
        raise AssertionError(f"boxqp_solve B={B}: max |dx| kernel vs plain {dx:.3e} > 3e-3")
    ms = time_ms(lambda: ak.boxqp_solve(*args, **prod_kw), reps)
    rounds = float((out_k[6] / iters).sum())  # rounds this run's data needed
    ops = rounds * ak.solve_flops_per_round(Kst, nz, nc, iters, True)
    t_ops = ops / PEAK_FP32_PER_S * 1e3
    t_bytes = ak.io_bytes(Kst, nz, nc, B, True, shared_hjk=True) / PEAK_BYTES_PER_S * 1e3
    records.append(dict(
        name="boxqp_solve", route="cuda",
        source="control_box_rst_tpu_torch/csrc/admm_kernel.cu",
        replaces="control_box_rst_tpu/ops/pallas/admm_kernel.py:483",
        launches=0, max_abs_err=dx, ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, on_main_path=True, batch=B,
        err_vs_f64=e_k, plain_err_vs_f64=e_p,
        same_it_frac=same_it, mean_rounds=rounds / B,
        max_rounds=float(out_k[6].max()) / iters,
        rounds_hist=torch.bincount((out_k[6] / iters).long()).tolist(),
        plain_mean_rounds=float(out_p[6].mean()) / iters,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
    ))

    # the main path's second launch: an outer SQP iteration calls the same
    # kernel for one round without the KKT exit, warm-started from the first
    # solve's duals. The step of a lane that has nearly converged is at the
    # float32 noise level, so the yardstick is again the float64 plain version.
    warm_args = config1_qps(ocp, x0s_all, step=out_k[0], y_d=out_k[2], y_b=out_k[3])
    warm_kw = dict(
        solve_kw, n_rounds=max(1, -(-qp.max_iter // iters)), iters=iters,
        tol=qp.tol, tol_stat=0.0, tol_feas=0.0,
    )
    w_k = ak.boxqp_solve(*warm_args, **warm_kw)
    w_p = ak.boxqp_solve_plain(*warm_args, **warm_kw)
    w_d = ak.boxqp_solve_plain(*as_f64(warm_args), **warm_kw)
    torch.cuda.synchronize()
    warm_errs = {}
    for i, nm in ((0, "x"), (2, "y_d"), (3, "y_b")):
        warm_errs[nm] = assert_as_close_as_plain(
            f"boxqp_solve B={B} warm round {nm}", w_k[i], w_p[i], w_d[i], floor=2e-5)
    d_rounds = (w_k[6] - w_p[6]).abs() / iters
    if not bool((d_rounds <= 1).all()) or float((d_rounds == 0).float().mean()) < 0.90:
        raise AssertionError(
            f"boxqp_solve B={B} warm round: per-lane rounds differ from the "
            f"plain version by up to {float(d_rounds.max())}")
    records[0]["warm_round_err_vs_f64"] = warm_errs
    records[0]["warm_round_max_abs_err"] = float((w_k[0] - w_p[0]).abs().max())

    out_k = ak.admm_round(*args, iters=iters, **base)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = ak.admm_round_plain(*args, iters=iters, **base)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out_d = ak.admm_round_plain(*as_f64(args), iters=iters, **base)
    e_k, e_p = assert_as_close_as_plain(
        f"admm_round B={B} x", out_k[0], out_p[0], out_d[0])
    assert_as_close_as_plain(f"admm_round B={B} y_d", out_k[2], out_p[2], out_d[2])
    assert_as_close_as_plain(f"admm_round B={B} y_b", out_k[3], out_p[3], out_d[3])
    ms = time_ms(lambda: ak.admm_round(*args, iters=iters, **base), reps)
    t_ops = B * ak.round_flops(Kst, nz, nc, iters) / PEAK_FP32_PER_S * 1e3
    t_bytes = ak.io_bytes(Kst, nz, nc, B, False, shared_hjk=True) / PEAK_BYTES_PER_S * 1e3
    records.append(dict(
        name="admm_round", route="cuda",
        source="control_box_rst_tpu_torch/csrc/admm_kernel.cu",
        replaces="control_box_rst_tpu/ops/pallas/admm_kernel.py:602",
        launches=0, max_abs_err=float((out_k[0] - out_p[0]).abs().max()),
        ms=ms, plain_ms=plain_ms,
        bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=None, on_main_path=False, batch=B,
        err_vs_f64=e_k, plain_err_vs_f64=e_p,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
    ))
    return records


def random_spd_systems(B, K, nz, device):
    """Well-conditioned random SPD block-tridiagonal systems (the systems of
    the JAX package's own kernel test, batched), made from a seed with numpy."""
    rng = np.random.default_rng(3)
    D = rng.standard_normal((B, K, nz, nz), dtype=np.float32)
    D = D @ D.transpose(0, 1, 3, 2) + 10 * np.eye(nz, dtype=np.float32)
    O = 0.3 * rng.standard_normal((B, K - 1, nz, nz), dtype=np.float32)
    b = rng.standard_normal((B, K, nz), dtype=np.float32)
    return [torch.as_tensor(a, device=device) for a in (D, O, b)]


def lm_systems(ocp, cfg, x0s, iterations):
    """The damped Gauss-Newton systems (Dmu, O, g) that the LM solve of the
    config-1 batch hands to the block-tridiagonal kernel at the given
    iterations (0 = the first), each lane with its own mu and weights."""
    from control_box_rst_tpu_torch.ocp.problem import Trajectory
    from control_box_rst_tpu_torch.solvers.lm import LMProblem, freeze_inactive

    o = ocp.replace(bc=ocp.bc.replace(x0=x0s))
    traj0 = o.apply_boundary(
        Trajectory.linear_interp(x0s, o.refs.xref[-1], o.N, o.nu, 0.1))
    prob = LMProblem(o, cfg, x0s.dtype)
    state = prob.init_state(o.pack(traj0))
    out = {}
    for it in range(max(iterations) + 1):
        if it in iterations:
            Dmu, _, O, g, _ = prob.damped_system(state)
            out[it] = (Dmu, O, g)
        state = freeze_inactive(prob.cond(state), prob.iteration(state), state)
    return out


def dense_library_ms(D, O, b, x_ref, reps):
    """Milliseconds of the one PyTorch call that computes the same function:
    Cholesky factor and solve of the dense [B, K*nz, K*nz] assembly (assembly
    not timed). Tried at the full batch and halved until it fits in memory;
    returns (ms, batch timed). A yardstick only: the port never calls it."""
    K, nz = D.shape[1], D.shape[2]
    n = K * nz
    B = D.shape[0]
    while B >= 1:
        try:
            M = torch.zeros((B, n, n), dtype=D.dtype, device=D.device)
            for k in range(K):
                sl = slice(k * nz, (k + 1) * nz)
                M[:, sl, sl] = D[:B, k]
                if k < K - 1:
                    nx = slice((k + 1) * nz, (k + 2) * nz)
                    M[:, sl, nx] = O[:B, k]
                    M[:, nx, sl] = O[:B, k].transpose(-1, -2)
            rhs = b[:B].reshape(B, n, 1)
            call = lambda: torch.cholesky_solve(rhs, torch.linalg.cholesky(M))
            x = call().reshape(B, K, nz)
            err = float((x - x_ref[:B]).abs().max())
            if not err <= 5e-5:
                raise AssertionError(f"dense library solve disagrees with the kernel: {err:.3e}")
            ms = time_ms(call, reps)
            del M, x
            torch.cuda.empty_cache()
            return ms, B
        except torch.cuda.OutOfMemoryError:
            M = x = None
            torch.cuda.empty_cache()
            B //= 2
    raise RuntimeError("the dense library solve fits at no batch size")


def phase_btridiag_kernels(ocp, lm_cfg, x0s_all, reps: int):
    """The two block-tridiagonal factor-and-solve kernels against their plain
    version; returns their records (three-sweep kernel first).

    On well-conditioned random SPD systems kernel and float32 plain version
    must agree to atol 5e-6 (the bound of the JAX package's own kernel test).
    LM's own systems J'J + mu I are badly conditioned once the penalty weights
    have grown (x10 per stall), so there the yardstick is the float64 plain
    version: the kernel must be as close to it as the float32 plain version is
    (slack 2x + 1e-5), on the lanes where all three are finite; a system that
    is not positive definite in float32 gives NaN in its lane on either side,
    and the kernel may not lose more lanes to that than the plain version
    (+5 % of its count, +0.1 % of the batch: a pivot at the rounding level
    falls on either side of zero).
    """
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

    B, K, nz = x0s_all.shape[0], ocp.N + 1, ocp.nz
    dev = x0s_all.device
    solve = {
        "btridiag_factor_solve": lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=False),
        "btridiag_factor_solve_inplace": lambda D, O, b: bk.btridiag_factor_solve(D, O, b, inplace=True),
    }
    errs = {}

    # ---- (i) random SPD systems, full batch ----
    D, O, b = random_spd_systems(B, K, nz, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    x_plain = bk.btridiag_factor_solve_plain(D, O, b)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    x_kern, max_err = {}, {}
    for name, fn in solve.items():
        x_kern[name] = fn(D, O, b)
        torch.cuda.synchronize()
        max_err[name] = assert_close(f"{name} random SPD", x_kern[name], x_plain, rtol=0.0, atol=5e-6)
    # ---- (iv) the two kernels against each other ----
    d34 = float((x_kern["btridiag_factor_solve"] - x_kern["btridiag_factor_solve_inplace"]).abs().max())
    if not d34 <= 1e-6:
        raise AssertionError(f"the two block-tridiagonal kernels differ by {d34:.3e} > 1e-6")
    errs["random/three_sweeps_vs_inplace"] = d34
    # ---- (iii) B = 1 (the other layout instance) and a ragged last tile ----
    for n in (1, 1000):
        for name, fn in solve.items():
            x_n = fn(D[:n], O[:n], b[:n])
            torch.cuda.synchronize()
            if not torch.equal(x_n, x_kern[name][:n]):
                errs[f"random/{name}_B{n}"] = assert_close(
                    f"{name} B={n}", x_n, x_plain[:n], rtol=0.0, atol=5e-6)
    # D and O broadcast over the batch (stride 0) are taken as they are
    De, Oe = D[0].expand(D[:64].shape), O[0].expand(O[:64].shape)
    x_b = solve["btridiag_factor_solve_inplace"](De, Oe, b[:64])
    torch.cuda.synchronize()
    assert_close("broadcast D/O", x_b, bk.btridiag_factor_solve_plain(De, Oe, b[:64]),
                 rtol=0.0, atol=5e-6)
    # the caller's D and O are not written by the in-place kernel
    D_before = D[:64].clone()
    solve["btridiag_factor_solve_inplace"](D[:64], O[:64], b[:64])
    torch.cuda.synchronize()
    if not torch.equal(D[:64], D_before):
        raise AssertionError("the in-place kernel wrote to the caller's D")

    # ---- times, bounds, library yardstick (random systems, full batch) ----
    ms = {name: time_ms(lambda fn=fn: fn(D, O, b), reps) for name, fn in solve.items()}
    lib_ms, lib_B = dense_library_ms(D, O, b, x_kern["btridiag_factor_solve_inplace"], 2)
    t_bytes = bk.io_bytes(K, nz, B) / PEAK_BYTES_PER_S * 1e3
    t_ops = B * bk.factor_solve_flops(K, nz) / PEAK_FP32_PER_S * 1e3
    del D, O, b, x_plain, x_kern

    # ---- (ii) LM's own systems on the config-1 batch ----
    systems = lm_systems(ocp, lm_cfg, x0s_all, (0, LM_LATE_ITERATION))
    lm_errs = {name: {} for name in solve}
    for it, (Dmu, O, g) in systems.items():
        x_p = bk.btridiag_factor_solve_plain(Dmu, O, g)
        x_d = bk.btridiag_factor_solve_plain(Dmu.double(), O.double(), g.double())
        fin = lambda x: torch.isfinite(x).all(dim=2).all(dim=1)
        for name, fn in solve.items():
            x_k = fn(Dmu, O, g)
            torch.cuda.synchronize()
            lost_k, lost_p = int((~fin(x_k)).sum()), int((~fin(x_p)).sum())
            if lost_k > 1.05 * lost_p + B // 1000:
                raise AssertionError(
                    f"{name} LM iteration {it}: {lost_k} non-finite lanes, the plain version {lost_p}")
            ok = fin(x_k) & fin(x_p) & fin(x_d)
            e_k, e_p = assert_as_close_as_plain(
                f"{name} LM iteration {it}", x_k[ok], x_p[ok], x_d[ok])
            lm_errs[name][f"it{it}"] = dict(
                err_vs_f64=e_k, plain_err_vs_f64=e_p, x_max=float(x_d[ok].abs().max()),
                nonfinite_lanes=lost_k, plain_nonfinite_lanes=lost_p)
    log(f"btridiag kernels[{B} lanes]: " + json.dumps({**errs, "lm_systems": lm_errs}))

    replaces = {
        "btridiag_factor_solve": "control_box_rst_tpu/ops/pallas/btridiag_kernel.py:194",
        "btridiag_factor_solve_inplace": "control_box_rst_tpu/ops/pallas/btridiag_kernel_v2.py:147",
    }
    return [dict(
        name=name, route="cuda",
        source="control_box_rst_tpu_torch/csrc/btridiag_kernel.cu",
        replaces=replaces[name], launches=0, max_abs_err=max_err[name],
        ms=ms[name], plain_ms=plain_ms, bound_ms=max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        library_ms=lib_ms, library_batch=lib_B, on_main_path=True, batch=B,
        bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
        three_sweeps_vs_inplace=d34, lm_systems=lm_errs[name],
    ) for name in solve]


def phase_main(ocp, cfg, x0s_np, trials: int, reps: int):
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    solver = make_batched_solver(ocp, cfg, dt_init=0.1)  # device=None: the card
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    solver(x0s[:256])  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    ak.reset_launch_counts()
    U, obj, status, iters = solver(x0s)
    torch.cuda.synchronize()
    launches = dict(ak.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    if U.shape != (B, ocp.N, ocp.nu) or not bool(torch.isfinite(U).all()):
        raise AssertionError(f"main path: U has shape {tuple(U.shape)} or non-finite values")
    if not bool(torch.isfinite(obj).all()):
        raise AssertionError("main path: non-finite objective")
    conv = float((status == 1).float().mean())
    gold = np.load(GOLDEN)
    n_g = gold["U"].shape[0]
    if not np.array_equal(gold["x0s"], x0s_np[:n_g]):
        raise AssertionError("golden file was made for other initial states")
    u_err = float(np.max(np.abs(U[:n_g].double().cpu().numpy() - gold["U"])))
    if launches["boxqp_solve"] <= 0:
        raise AssertionError("main path did not launch the boxqp_solve kernel")
    if conv < CONV_GATE:
        raise AssertionError(f"converged_frac {conv:.4f} < {CONV_GATE}")
    if not (u_err <= ERR_GATE):
        raise AssertionError(f"max |U - U_oracle| {u_err:.3e} > {ERR_GATE}")

    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            solver(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)

    x0_1 = x0s[:1]
    solver(x0_1)
    torch.cuda.synchronize()
    lats = []
    for _ in range(50):
        t0 = time.perf_counter()
        solver(x0_1)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)

    return launches, dict(
        batch=B, solves_per_s=B * reps / best, batch_solve_ms=best / reps * 1e3,
        converged_frac=conv, max_u_err_vs_f64_oracle=u_err,
        mean_sqp_iters=float(iters.float().mean()),
        max_sqp_iters=int(iters.max()),
        launches=launches, peak_device_memory_gib=peak_gb,
        p99_single_solve_ms=float(np.percentile(np.asarray(lats), 99) * 1e3),
        p50_single_solve_ms=float(np.percentile(np.asarray(lats), 50) * 1e3),
    )


def phase_lm(ocp, cfg, x0s_np, trials: int):
    """The batched LM solve of config 1 through the in-place kernel, then once
    more through the three-sweep kernel; returns the launch counts of the two
    runs and the record of the ``{"lm": ...}`` line.

    Gates. The float64 LM of the reference is the golden file; but float32 LM
    does not reproduce float64 LM lane by lane in ANY implementation: its
    accept and stall tests sit below float32 resolution near the solution, a
    stall at an infeasible point multiplies the penalty weights by 10, and
    the weights a lane ends with decide its answer. The reference's own
    float32 solve of the golden lanes (in the file) is up to 0.46 from its
    float64 solve. So the port's float32 solve on the card is held to being as
    close to the float64 golden as the reference's float32 solve is: mean and
    max over the golden lanes of the per-lane max |U - U_golden|, and of the
    relative chi2 gap, each <= 2x the reference's + 1e-3; the median |U| error
    <= 1e-3 outright.
    """
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.parallel import make_batched_lm_solver

    solver = make_batched_lm_solver(ocp, cfg, dt_init=0.1)  # device=None: the card
    B = x0s_np.shape[0]
    x0s = torch.as_tensor(x0s_np, device="cuda")
    solver(x0s[:256])  # warm-up
    torch.cuda.synchronize()

    torch.cuda.reset_peak_memory_stats()
    bk.reset_launch_counts()
    t0 = time.perf_counter()
    U, chi2, status, iters, feas = solver(x0s)
    torch.cuda.synchronize()
    best = time.perf_counter() - t0
    launches = dict(bk.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30

    if U.shape != (B, ocp.N, ocp.nu) or not bool(torch.isfinite(U).all()):
        raise AssertionError(f"LM path: U has shape {tuple(U.shape)} or non-finite values")
    conv = float((status == 1).float().mean())
    if launches["btridiag_factor_solve_inplace"] <= 0 or launches["btridiag_factor_solve"] != 0:
        raise AssertionError(f"LM path: unexpected kernel launches {launches}")
    if conv < CONV_GATE:
        raise AssertionError(f"LM converged_frac {conv:.4f} < {CONV_GATE}")

    gold = np.load(LM_GOLDEN)
    n_g = gold["U"].shape[0]
    if not np.array_equal(gold["x0s"], x0s_np[:n_g]):
        raise AssertionError("LM golden file was made for other initial states")
    lane_err = lambda u: np.abs(u - gold["U"]).max(axis=(1, 2))
    chi_gap = lambda c: np.abs(c - gold["chi2"]) / (1.0 + gold["chi2"])
    e_port, e_ref = lane_err(U[:n_g].double().cpu().numpy()), lane_err(gold["U_f32"])
    c_port, c_ref = chi_gap(chi2[:n_g].double().cpu().numpy()), chi_gap(gold["chi2_f32"])
    c_port = c_port[np.isfinite(c_port)]  # inf: a lane whose weights grew last
    quality = dict(
        u_err_median=float(np.median(e_port)), u_err_mean=float(e_port.mean()),
        u_err_max=float(e_port.max()), lanes_above_1e3=int((e_port > 1e-3).sum()),
        ref_f32_u_err_median=float(np.median(e_ref)), ref_f32_u_err_mean=float(e_ref.mean()),
        ref_f32_u_err_max=float(e_ref.max()), ref_f32_lanes_above_1e3=int((e_ref > 1e-3).sum()),
        chi2_gap_mean=float(c_port.mean()), chi2_gap_max=float(c_port.max()),
        ref_f32_chi2_gap_mean=float(c_ref.mean()), ref_f32_chi2_gap_max=float(c_ref.max()),
    )
    log("lm quality vs f64 golden: " + json.dumps(quality))
    for key in ("u_err_mean", "u_err_max", "chi2_gap_mean", "chi2_gap_max"):
        if not quality[key] <= 2.0 * quality["ref_f32_" + key] + 1e-3:
            raise AssertionError(
                f"LM {key} {quality[key]:.3e} > 2 x the reference's float32 "
                f"{quality['ref_f32_' + key]:.3e} + 1e-3")
    if not quality["u_err_median"] <= ERR_GATE:
        raise AssertionError(f"LM median |U - U_golden| {quality['u_err_median']:.3e} > {ERR_GATE}")

    for _ in range(trials - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solver(x0s)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t0)

    # the same batch through the three-sweep kernel: same U
    solver3 = make_batched_lm_solver(ocp, cfg, dt_init=0.1, inplace=False)
    bk.reset_launch_counts()
    U3, _, status3, iters3, _ = solver3(x0s)
    torch.cuda.synchronize()
    launches3 = dict(bk.LAUNCHES)
    if launches3["btridiag_factor_solve"] <= 0 or launches3["btridiag_factor_solve_inplace"] != 0:
        raise AssertionError(f"LM path (three sweeps): unexpected kernel launches {launches3}")
    du3 = float((U3 - U).abs().max())
    if not du3 <= 1e-6 or not torch.equal(status3, status):
        raise AssertionError(f"LM through the two kernels differs: max |dU| {du3:.3e}")

    x0_1 = x0s[:1]
    solver(x0_1)
    torch.cuda.synchronize()
    lats = []
    for _ in range(20):
        t0 = time.perf_counter()
        solver(x0_1)
        torch.cuda.synchronize()
        lats.append(time.perf_counter() - t0)

    counts = {
        "btridiag_factor_solve_inplace": launches["btridiag_factor_solve_inplace"],
        "btridiag_factor_solve": launches3["btridiag_factor_solve"],
    }
    return counts, dict(
        batch=B, solves_per_s=B / best, batch_solve_ms=best * 1e3,
        converged_frac=conv, mean_lm_iters=float(iters.float().mean()),
        max_lm_iters=int(iters.max()), max_feas_res=float(feas.max()),
        launches=counts, max_du_three_sweeps_vs_inplace=du3,
        peak_device_memory_gib=peak_gb, **quality,
        p50_single_solve_ms=float(np.percentile(np.asarray(lats), 50) * 1e3),
        p99_single_solve_ms=float(np.percentile(np.asarray(lats), 99) * 1e3),
    )


def phase_profile(solvers, x0s_np, top: int = 14):
    """torch.profiler over one batched solve of each main path and one single
    SQP solve: device time by kernel name, and the share of the wall time the
    device sat idle. ``solvers``: label -> (solver, number of lanes)."""
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for label, (solver, lanes) in solvers.items():
        x = torch.as_tensor(x0s_np[:lanes], device="cuda")
        solver(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solver(x)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [
            (e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type == torch.autograd.DeviceType.CUDA
        ]
        rows.sort(key=lambda r: -r[1])
        busy_ms = sum(r[1] for r in rows)
        out[label] = dict(
            wall_ms=wall_ms, device_busy_ms=busy_ms,
            device_idle_share=max(0.0, 1.0 - busy_ms / wall_ms),
            n_device_kernels=int(sum(r[2] for r in rows)),
            top=[dict(name=r[0][:60], ms=r[1], calls=r[2]) for r in rows[:top]],
        )
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also trace one batched solve of each main path and one "
                         "single solve with torch.profiler")
    ap.add_argument("--skip-main", action="store_true",
                    help="stop after the kernel phase (no result line)")
    opts = ap.parse_args()

    # ---- 1 device ----
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device present", file=sys.stderr)
        return 1
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    from control_box_rst_tpu_torch.entry import flagship, flagship_lm
    from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
    from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
    from control_box_rst_tpu_torch.ops.cuda import build

    # ---- 2 build ----
    ocp, cfg = flagship(N=50)
    _, lm_cfg = flagship_lm(N=50)
    t0 = time.perf_counter()
    libs = build.build_all(
        [ak.build_spec(ocp.nz, ocp.nc), bk.build_spec(ocp.nz)], verbose=True)
    log(f"build: {', '.join(lib.name for lib in libs)} in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(0)
    x0s_np = rng.uniform(-1.0, 1.0, size=(BATCH, 2)).astype(np.float32)

    # ---- 3 kernels ----
    ocp_dev = ocp.to(device="cuda", dtype=torch.float32)
    x0s_dev = torch.as_tensor(x0s_np, device="cuda")
    records = phase_kernels(ocp_dev, cfg, x0s_dev, SMALL_BATCH, KERNEL_REPS)
    records += phase_btridiag_kernels(ocp_dev, lm_cfg, x0s_dev, KERNEL_REPS)
    if opts.skip_main:
        log(json.dumps({"kernels": records}))
        return 3

    # ---- 4 main path (SQP), 5 LM path ----
    launches, main_rec = phase_main(ocp, cfg, x0s_np, TRIALS, REPS)
    lm_launches, lm_rec = phase_lm(ocp, lm_cfg, x0s_np, LM_TRIALS)
    launches = {**launches, **lm_launches}  # each count from its own path's run
    for r in records:
        r["launches"] = launches[r["name"]]
        if r["on_main_path"] and r["launches"] <= 0:
            raise AssertionError(f"kernel {r['name']} was not launched by its main path")

    if opts.profile:
        from control_box_rst_tpu_torch.parallel import (
            make_batched_lm_solver,
            make_batched_solver,
        )

        sqp = make_batched_solver(ocp, cfg, dt_init=0.1)
        lm = make_batched_lm_solver(ocp, lm_cfg, dt_init=0.1)
        log(json.dumps({"profile": phase_profile(
            {"batch": (sqp, BATCH), "single": (sqp, 1), "lm_batch": (lm, BATCH)},
            x0s_np)}))

    # ---- 6 result ----
    log(json.dumps({"main": main_rec}))
    log(json.dumps({"lm": lm_rec}))
    log(smi)
    log(json.dumps({"kernels": records}))
    log(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
