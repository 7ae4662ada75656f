"""PyTorch port vs JAX package: ops/smallmat.py and ops/btridiag.py.

Same numpy inputs (from a seed) through both, float64, tolerance 1e-10: the
two sides run the same unrolled recurrences, so they differ by rounding only.
The JAX side is always called under ``jax.jit``, as everywhere in the
tests/test_torch_*.py files: op-by-op (eager) JAX on this CPU backend has
been seen to corrupt the heap in AD transposes, the jitted form has not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ops import btridiag as jbt
from control_box_rst_tpu.ops import smallmat as jsm
from control_box_rst_tpu_torch.ops import btridiag as tbt
from control_box_rst_tpu_torch.ops import smallmat as tsm

from torch_port_util import to_np

torch.set_num_threads(1)
TOL = 1e-10
B, n, m = 3, 4, 2


def _spd(rng, *lead):
    A = rng.standard_normal(lead + (n, n))
    return A @ np.swapaxes(A, -1, -2) + n * np.eye(n)


def _both(name, *arrays):
    out_j = jax.jit(getattr(jsm, name))(*(jnp.asarray(a) for a in arrays))
    out_t = getattr(tsm, name)(*(torch.from_numpy(a) for a in arrays))
    return np.asarray(out_j), to_np(out_t)


def _lower(rng):
    return np.linalg.cholesky(_spd(rng, B))


SMALLMAT_CASES = {
    "chol_small": lambda r: (_spd(r, B),),
    "solve_lower_vec": lambda r: (_lower(r), r.standard_normal((B, n))),
    "solve_upperT_vec": lambda r: (_lower(r), r.standard_normal((B, n))),
    "solve_lower_mat": lambda r: (_lower(r), r.standard_normal((B, n, m))),
    "chol_solve_vec": lambda r: (_lower(r), r.standard_normal((B, n))),
    "mm_small": lambda r: (r.standard_normal((B, m, n)), r.standard_normal((B, n, 3))),
    "mm_small_tn": lambda r: (r.standard_normal((B, n, m)), r.standard_normal((B, n, 3))),
    "mm_small_nt": lambda r: (r.standard_normal((B, m, n)), r.standard_normal((B, 3, n))),
    "mv_small": lambda r: (r.standard_normal((B, m, n)), r.standard_normal((B, n))),
    "mv_small_t": lambda r: (r.standard_normal((B, n, m)), r.standard_normal((B, n))),
}


@pytest.mark.parametrize("name", sorted(SMALLMAT_CASES))
def test_smallmat_matches_jax(name):
    arrays = SMALLMAT_CASES[name](np.random.default_rng(3))
    out_j, out_t = _both(name, *arrays)
    assert out_t.dtype == np.float64
    np.testing.assert_allclose(out_t, out_j, rtol=TOL, atol=TOL)


def _btridiag_problem(seed, K=6):
    rng = np.random.default_rng(seed)
    O = rng.standard_normal((K - 1, n, n)) * 0.3
    D = _spd(rng, K) + 2.0 * np.eye(n)
    b = rng.standard_normal((K, n))
    return D, O, b


def test_btridiag_cholesky_and_solve_match_jax():
    D, O, b = _btridiag_problem(0)
    Ld_j, Lo_j = jax.jit(jbt.btridiag_cholesky)(jnp.asarray(D), jnp.asarray(O))
    x_j = jax.jit(jbt.btridiag_solve)(Ld_j, Lo_j, jnp.asarray(b))
    Ld_t, Lo_t = tbt.btridiag_cholesky(torch.from_numpy(D), torch.from_numpy(O))
    x_t = tbt.btridiag_solve(Ld_t, Lo_t, torch.from_numpy(b))
    np.testing.assert_allclose(to_np(Ld_t), np.asarray(Ld_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(Lo_t), np.asarray(Lo_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(x_t), np.asarray(x_j), rtol=TOL, atol=TOL)


def test_btridiag_batched_equals_per_lane():
    """The batch is a written-out leading dim: solving [B, …] at once gives
    each lane what solving it alone gives (1e-12: same arithmetic)."""
    probs = [_btridiag_problem(s) for s in (1, 2, 3)]
    D, O, b = (torch.from_numpy(np.stack(a)) for a in zip(*probs))
    Ld, Lo = tbt.btridiag_cholesky(D, O)
    x = tbt.btridiag_solve(Ld, Lo, b)
    for i in range(3):
        Ld_i, Lo_i = tbt.btridiag_cholesky(D[i], O[i])
        x_i = tbt.btridiag_solve(Ld_i, Lo_i, b[i])
        np.testing.assert_allclose(to_np(x[i]), to_np(x_i), rtol=1e-12, atol=1e-12)


def test_btridiag_matvec_and_dense_match_jax():
    D, O, b = _btridiag_problem(4)
    M_j = jax.jit(jbt.btridiag_dense)(jnp.asarray(D), jnp.asarray(O))
    y_j = jax.jit(jbt.btridiag_matvec)(jnp.asarray(D), jnp.asarray(O), jnp.asarray(b))
    Dt, Ot, bt = (torch.from_numpy(a) for a in (D, O, b))
    M_t = tbt.btridiag_dense(Dt, Ot)
    np.testing.assert_allclose(to_np(M_t), np.asarray(M_j), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(
        to_np(tbt.btridiag_matvec(Dt, Ot, bt)), np.asarray(y_j), rtol=TOL, atol=TOL
    )


def test_btridiag_solve_against_dense():
    """Factor + solve against a dense solve of the materialized matrix."""
    D, O, b = (torch.from_numpy(a) for a in _btridiag_problem(5))
    Ld, Lo = tbt.btridiag_cholesky(D, O)
    x = tbt.btridiag_solve(Ld, Lo, b)
    x_dense = torch.linalg.solve(tbt.btridiag_dense(D, O), b.reshape(-1))
    np.testing.assert_allclose(
        to_np(x).reshape(-1), to_np(x_dense), rtol=TOL, atol=TOL
    )
