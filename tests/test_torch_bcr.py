"""PyTorch port vs JAX package: block cyclic reduction (``ops/btridiag_cr.py``)
and ``linsolver='bcr'`` of the non-fused ADMM, in float64.

- ``bcr_factor`` / ``bcr_solve`` on seeded SPD block-tridiagonal systems
  (three lanes a batch, K ∈ {1, 2, 5, 9, 17}, nz ∈ {2, 4}: the padding to
  2^m + 1 stages and the one-stage case) against the dense solve, the
  sequential block Cholesky of ``ops/btridiag.py`` and the JAX ``bcr_solve``
  under ``jax.vmap`` (1e-12).
- The non-fused ADMM with ``linsolver='bcr'`` against the JAX one on the
  random QPs of tests/test_admm_pallas.py (1e-8, as the multi-round cases
  of tests/test_torch_stage_qp.py), against the port's own 'scan' (1e-9),
  and one ρ-round (``_round_reference_fn``) against the JAX one (1e-10).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ops.btridiag_cr import bcr_factor as j_bcr_factor
from control_box_rst_tpu.ops.btridiag_cr import bcr_solve as j_bcr_solve
from control_box_rst_tpu.solvers import stage_qp as jqp
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.ops.btridiag import (
    btridiag_cholesky,
    btridiag_dense,
    btridiag_solve,
)
from control_box_rst_tpu_torch.ops.btridiag_cr import bcr_factor, bcr_solve
from control_box_rst_tpu_torch.solvers import stage_qp as tqp

from torch_port_util import jax_stage_qp, kernel_args_np, random_qp_batch_np, to_np

torch.set_num_threads(1)
TOL = 1e-12
B = 3
SEEDS = (10, 11, 12, 13)


def _systems(K, nz, seed):
    """B SPD block-tridiagonal systems (diagonally dominant blocks) and
    right-hand sides from a seed."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, K, nz, nz)) * 0.2 + np.eye(nz) * (4.0 + np.arange(K) % 3)[:, None, None]
    D = 0.5 * (D + np.swapaxes(D, -1, -2))
    O = 0.3 * rng.standard_normal((B, max(K - 1, 0), nz, nz))
    b = rng.standard_normal((B, K, nz))
    return D, O, b


@pytest.mark.parametrize("nz", [2, 4])
@pytest.mark.parametrize("K", [1, 2, 5, 9, 17])
def test_bcr_matches_dense_scan_and_jax(K, nz):
    D, O, b = _systems(K, nz, seed=100 * K + nz)
    Dt, Ot, bt = map(torch.as_tensor, (D, O, b))
    x = bcr_solve(bcr_factor(Dt, Ot), bt)
    assert x.shape == (B, K, nz)
    dense = np.stack([
        np.linalg.solve(to_np(btridiag_dense(Dt[i], Ot[i])), b[i].ravel()).reshape(K, nz)
        for i in range(B)])
    np.testing.assert_allclose(to_np(x), dense, rtol=0, atol=TOL)
    if K > 1:
        scan = btridiag_solve(*btridiag_cholesky(Dt, Ot), bt)
        np.testing.assert_allclose(to_np(x), to_np(scan), rtol=0, atol=TOL)
    want = jax.jit(jax.vmap(lambda d, o, r: j_bcr_solve(j_bcr_factor(d, o), r)))(
        *map(jnp.asarray, (D, O, b)))
    np.testing.assert_allclose(to_np(x), np.asarray(want), rtol=0, atol=TOL)
    # one system shared by the lanes broadcasts against batched right-hand sides
    x1 = bcr_solve(bcr_factor(Dt[0], Ot[0]), bt)
    np.testing.assert_allclose(to_np(x1[0]), to_np(x[0]), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", ["vs_jax", "vs_scan"])
def test_admm_bcr(case):
    """The non-fused ADMM over 4 rounds of 10 iterations with per-lane ρ."""
    d = random_qp_batch_np(SEEDS)
    kw = dict(max_iter=40, iters_per_round=10, tol=1e-8)
    qp_t = convert.stage_qp_from_numpy(d, torch.float64, "cpu")
    sol_t = tqp.solve_stage_qp(qp_t, tqp.QPConfig(linsolver="bcr", **kw))
    if case == "vs_jax":
        want = jax.jit(jax.vmap(
            lambda qp: jqp.solve_stage_qp(qp, jqp.QPConfig(backend="xla", linsolver="bcr", **kw))
        ))(jax_stage_qp(d, jnp.float64))
        tol = 1e-8
    else:
        want = tqp.solve_stage_qp(qp_t, tqp.QPConfig(linsolver="scan", **kw))
        tol = 1e-9
    for name in ("delta", "y_dyn", "y_box", "prim_res", "dual_res"):
        np.testing.assert_allclose(to_np(getattr(sol_t, name)), to_np(getattr(want, name)),
                                   rtol=tol, atol=tol, err_msg=name)
    np.testing.assert_array_equal(to_np(sol_t.iters), to_np(want.iters))


def test_round_reference_bcr_matches_jax():
    """One ρ-round of 12 iterations factored by block cyclic reduction."""
    d = random_qp_batch_np(SEEDS)
    args = kernel_args_np(d, 0.7, np.float64)
    want = jax.jit(jax.vmap(jqp._round_reference_fn(jqp.QPConfig(linsolver="bcr"), 12)))(
        *map(jnp.asarray, args))
    got = tqp._round_reference_fn(tqp.QPConfig(linsolver="bcr"), 12)(*map(torch.as_tensor, args))
    for g, w in zip(got, want):
        np.testing.assert_allclose(to_np(g), np.asarray(w), rtol=1e-10, atol=1e-10)
