"""PyTorch port vs JAX package: grid adaptation (``ocp/adaptation.py``).

``stage_mask_from_n``, ``resample_W`` and the six strategies take a batch of
lanes in the port and one lane under ``jax.vmap`` in the reference. The same
float64 inputs, made from a seed with numpy, go to both: lanes with
different active horizons, and the edges of each strategy (a split at the
last active interval, a merge at the first, the n_min / n_max clamps,
``GrowOnInfeasibility`` with and without ``feas``, ties of ``searchsorted``
on the flat tail of the old time grid). Results must agree to 1e-12;
horizons and every discrete decision exactly.

The reference runs op by op under ``jax.vmap``, not under ``jax.jit``: the
compiled ``resample_W`` places the held tail times i·T/n_new (i ≥ n_new) an
ulp below T, so the controls it holds on the inactive tail come from the last
active interval instead of interval N−1. The port equals the op-by-op
function; only cost-free inactive entries differ from the compiled one
(``test_resample_W_matches_jax`` shows both).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ocp import adaptation as jad
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.ocp import adaptation as tad

from torch_port_util import to_np

NX, NU = 2, 1
TOL = 1e-12


def _W(seed, B, N, dts=None, U=None):
    """Random states, controls and dts of B lanes [B, N+1, 4]; stage N's
    control and dt are 0, as ``pack`` leaves them."""
    rng = np.random.default_rng(seed)
    X = np.cumsum(rng.standard_normal((B, N + 1, NX)), axis=1)
    U = rng.uniform(-1.0, 1.0, (B, N, NU)) if U is None else U
    dts = rng.uniform(0.05, 0.3, (B, N)) if dts is None else dts
    W = np.zeros((B, N + 1, NX + NU + 1))
    W[:, :, :NX] = X
    W[:, :-1, NX:NX + NU] = U
    W[:, :-1, -1] = dts
    return W


def _jax_adapt(ad, W, n, N, feas=None):
    if feas is None:
        fn = jax.vmap(lambda w, k: ad.adapt(w, k, NX, NU, N))
        return fn(jnp.asarray(W), jnp.asarray(n, jnp.int32))
    fn = jax.vmap(lambda w, k, f: ad.adapt(w, k, NX, NU, N, feas=f))
    return fn(jnp.asarray(W), jnp.asarray(n, jnp.int32), jnp.asarray(feas))


def _port_adapt(ad, W, n, N, feas=None):
    f = None if feas is None else torch.as_tensor(feas)
    return ad.adapt(torch.as_tensor(W), torch.as_tensor(n, dtype=torch.int32), NX, NU, N, feas=f)


def _same(kind, fields, W, n, N, feas=None):
    """The strategy ``kind`` of both packages on the same lanes: equal
    horizons, W within TOL. Returns the port's (W, n)."""
    W_j, n_j = _jax_adapt(getattr(jad, kind)(**fields), W, n, N, feas)
    W_t, n_t = _port_adapt(convert.adaptation_from_numpy(dict(kind=kind, **fields)), W, n, N, feas)
    assert n_t.dtype == torch.int32
    np.testing.assert_array_equal(to_np(n_t), np.asarray(n_j))
    np.testing.assert_allclose(to_np(W_t), np.asarray(W_j), rtol=0, atol=TOL)
    return to_np(W_t), to_np(n_t)


def test_stage_mask_from_n_matches_jax():
    N = 10
    n = np.array([0, 1, 4, 9, 10], np.int32)
    got = tad.stage_mask_from_n(torch.as_tensor(n), N, torch.float64)
    want = jax.vmap(lambda k: jad.stage_mask_from_n(k, N, jnp.float64))(jnp.asarray(n))
    assert got.shape == (5, N) and got.dtype == torch.float64
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    # a number gives one row
    np.testing.assert_array_equal(
        to_np(tad.stage_mask_from_n(3, N, torch.float64, "cpu")), (np.arange(N) < 3).astype(float))


@pytest.mark.parametrize("dyadic", [True, False], ids=["dyadic_dts", "random_dts"])
def test_resample_W_matches_jax(dyadic):
    """Lanes that keep, halve, shrink by one, grow to N and grow from one
    interval, on a grid whose inactive tail has dt = 0 (so the old time grid
    is flat there and ``searchsorted(right=True)`` meets ties). Dyadic dts
    make every time exact in both packages, so the ties of the new times
    with the old knots are the same ties; random dts test the arithmetic."""
    N, B = 10, 6
    n_old = np.array([10, 10, 6, 6, 1, 8], np.int32)
    n_new = np.array([10, 5, 5, 10, 4, 8], np.int32)
    rng = np.random.default_rng(3)
    dts = (rng.integers(1, 8, (B, N)) / 16.0) if dyadic else rng.uniform(0.05, 0.3, (B, N))
    dts = dts * (np.arange(N) < n_old[:, None])  # inactive tail dt = 0
    W = _W(0, B, N, dts=dts)
    got = tad.resample_W(torch.as_tensor(W), NX, NU, torch.as_tensor(n_old), torch.as_tensor(n_new), N)
    fn = jax.vmap(lambda w, a, b: jad.resample_W(w, NX, NU, a, b, N))
    args = (jnp.asarray(W), jnp.asarray(n_old), jnp.asarray(n_new))
    want = fn(*args)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=0, atol=TOL)
    # compiled, the reference holds other controls on the inactive tail
    # only: every active interval's control, every state and dt agree
    jitted = np.asarray(jax.jit(fn)(*args))
    active = np.arange(N + 1) < n_new[:, None]
    np.testing.assert_allclose(to_np(got)[active], jitted[active], rtol=0, atol=TOL)
    np.testing.assert_allclose(to_np(got)[..., [0, 1, 3]], jitted[..., [0, 1, 3]], rtol=0, atol=TOL)
    if dyadic:
        # the same interval picked for every new time: the held controls and
        # the new dts are the same bits (the states go through an
        # interpolation that XLA may contract into a fused multiply-add)
        np.testing.assert_array_equal(to_np(got)[..., NX:], np.asarray(want)[..., NX:])
    # the new grid: T kept, dt = T/n_new on the active intervals, 0 after
    T = dts.sum(axis=1)
    new_dts = to_np(got)[:, :-1, -1]
    for b in range(B):
        np.testing.assert_allclose(new_dts[b, : n_new[b]], T[b] / n_new[b], rtol=1e-15)
        assert np.all(new_dts[b, n_new[b]:] == 0.0)
    # unbatched W with numbers for the counts: the first lane
    one = tad.resample_W(torch.as_tensor(W[0]), NX, NU, int(n_old[0]), int(n_new[0]), N)
    np.testing.assert_array_equal(to_np(one), to_np(got)[0])


def test_time_based_single_step_matches_jax():
    """Per-lane mean active dt above, below and inside the band; growth
    blocked at n_max, shrinking at n_min."""
    N = 10
    mean_dt = np.array([0.2, 0.05, 0.1, 0.2, 0.05, 0.105])
    n = np.array([6, 6, 6, 8, 3, 7], np.int32)
    dts = mean_dt[:, None] * np.ones((6, N)) * (np.arange(N) < n[:, None])
    W, n_new = _same("TimeBasedSingleStep", dict(dt_ref=0.1, dt_hyst_ratio=0.1, n_min=3, n_max=8),
                     _W(1, 6, N, dts=dts), n, N)
    np.testing.assert_array_equal(n_new, [7, 5, 6, 8, 3, 7])


def test_time_based_aggressive_estimate_matches_jax():
    """round(n·dt/dt_ref) clipped to [n_min, n_max], the band holding it."""
    N = 20
    mean_dt = np.array([0.2, 0.05, 0.1, 0.9, 0.01, 0.125])
    n = np.array([10, 10, 10, 10, 10, 10], np.int32)
    dts = mean_dt[:, None] * np.ones((6, N)) * (np.arange(N) < n[:, None])
    W, n_new = _same("TimeBasedAggressiveEstimate",
                     dict(dt_ref=0.1, dt_hyst_ratio=0.1, n_min=3, n_max=N),
                     _W(2, 6, N, dts=dts), n, N)
    np.testing.assert_array_equal(n_new, [20, 5, 10, 20, 3, 12])


def test_simple_shrinking_horizon_matches_jax():
    N = 10
    n = np.array([10, 6, 5, 4, 2], np.int32)
    dts = _W(3, 5, N)[:, :-1, -1] * (np.arange(N) < n[:, None])
    W, n_new = _same("SimpleShrinkingHorizon", dict(n_min=4), _W(3, 5, N, dts=dts), n, N)
    np.testing.assert_array_equal(n_new, [9, 5, 4, 4, 4])


def test_grow_on_infeasibility_matches_jax():
    """Grows where feas > feas_tol and n < n_max, copying the last active
    interval's control and dt into the new one; no feas, no change."""
    N = 10
    n = np.array([5, 5, 10, 9, 1], np.int32)
    feas = np.array([1.0, 1e-6, 1.0, 2e-3, 5.0])
    W0 = _W(4, 5, N)
    W, n_new = _same("GrowOnInfeasibility", dict(feas_tol=1e-3, n_max=N), W0, n, N, feas=feas)
    np.testing.assert_array_equal(n_new, [6, 5, 10, 10, 2])
    np.testing.assert_array_equal(W[0, 5, NX:], W0[0, 4, NX:])
    np.testing.assert_array_equal(W[0, 5, :NX], W0[0, 5, :NX])
    np.testing.assert_array_equal(W[1], W0[1])
    W, n_same = _same("GrowOnInfeasibility", dict(feas_tol=1e-3, n_max=N), W0, n, N)
    np.testing.assert_array_equal(n_same, n)
    np.testing.assert_array_equal(W, W0)


def test_redundant_controls_matches_jax():
    """One structural change per lane: split (no redundant interval), merge
    (several), neither (exactly ``backup``); the split at the last active
    interval and the merge at the first; n_max blocks a split and n_min a
    merge; a collapsed dt counts as redundant; ties of the largest dt go to
    the first."""
    N, B = 10, 9
    n = np.array([6, 6, 6, 8, 8, 10, 3, 7, 6], np.int32)
    rng = np.random.default_rng(5)
    U = rng.uniform(-1.0, 1.0, (B, N, NU)) * 10.0  # far apart: nothing redundant
    dts = rng.uniform(0.05, 0.1, (B, N))
    U[1, :] = 0.5                       # lane 1: all redundant -> merge at k = 0
    U[2, 2:4] = 0.25                    # lane 2: exactly one redundant pair -> no change
    dts[3, 7] = 0.4                     # lane 3: largest dt on the last active interval
    U[4, 3:6] = -1.0                    # lane 4: merge at k = 3 (the first redundant)
    # lane 5: n = N = n_max, nothing redundant -> the split is blocked
    U[6, :] = 1.0                       # lane 6: all redundant but n = n_min = 3 -> blocked
    dts[7, 2] = 1e-8                    # lane 7: a collapsed dt is redundant (one) ...
    U[7, 4:6] = 0.0                     # ... plus a repeated control: two -> merge at k = 2
    dts[8, 1] = dts[8, 4] = 0.3         # lane 8: tie of the largest dt -> split the first
    dts = dts * (np.arange(N) < n[:, None])
    W, n_new = _same("RedundantControls", dict(epsilon=1e-3, backup=1, n_min=3, n_max=N),
                     _W(6, B, N, dts=dts, U=U), n, N)
    np.testing.assert_array_equal(n_new, [7, 5, 6, 9, 7, 10, 3, 6, 7])
    # the split of lane 3 at its last active interval halves that dt
    np.testing.assert_array_equal(W[3, 7:9, -1], [0.2, 0.2])
    # lane 8 split at k = 1, not k = 4
    np.testing.assert_array_equal(W[8, 1:3, -1], [0.15, 0.15])
    # total active time kept by every split and merge
    np.testing.assert_allclose(
        (W[:, :-1, -1] * (np.arange(N) < n_new[:, None])).sum(axis=1), dts.sum(axis=1),
        rtol=1e-14)


def test_base_adaptation_is_the_identity_and_convert_refuses_unknown_kinds():
    W = _W(7, 3, 6)
    n = np.array([6, 3, 2], np.int32)
    W_t, n_t = _port_adapt(convert.adaptation_from_numpy(dict(kind="GridAdaptation")), W, n, 6)
    np.testing.assert_array_equal(to_np(W_t), W)
    np.testing.assert_array_equal(to_np(n_t), n)
    ad = convert.adaptation_from_numpy(
        dict(kind="RedundantControls", epsilon=np.asarray(1e-3), backup=np.int64(2), n_max=9))
    assert (ad.epsilon, ad.backup, ad.n_min, ad.n_max) == (1e-3, 2, 2, 9)
    assert isinstance(ad.backup, int) and isinstance(ad.epsilon, float)
    with pytest.raises(KeyError):
        convert.adaptation_from_numpy(dict(kind="NoSuchAdaptation"))
