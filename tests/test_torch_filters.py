"""The port's filters and dead-time buffer (``models/filters.py``) against the
JAX package's, step by step, float64 on the CPU.

The cases of ``tests/test_core_periphery.py`` (moving average, median,
least squares, the dead-time buffer) and seeded random sequences: the port
filters a batch of sequences at once (the carry batch-first), the reference
one sequence per call; every filtered value within 1e-12 (the least-squares
fit within 1e-10: two LU solves of the same normal equations), the carries'
counts equal. The one-step predictor landed with the closed loop and keeps
its own test there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.models import filters as jf

from control_box_rst_tpu_torch.models import filters as tf

LANES, STEPS = 4, 12

FILTERS = {
    "average": (lambda m, w: m.MovingAverageFilter(window=w), 1e-12),
    "median": (lambda m, w: m.MovingMedianFilter(window=w), 1e-12),
    "least_squares": (lambda m, w: m.MovingLeastSquaresFilter(window=w, order=2), 1e-10),
}


def _run_jax(filt, samples):
    carry = filt.init_carry()
    outs, counts = [], []
    for i, v in enumerate(samples):
        carry, o = filt(carry, float(i), jnp.asarray(v))
        outs.append(float(o))
        counts.append(int(carry.count))
    return np.asarray(outs), np.asarray(counts)


def _run_port(filt, seqs):
    carry = filt.init_carry(batch_shape=(seqs.shape[0],), dtype=torch.float64, device="cpu")
    outs, counts = [], []
    for i in range(seqs.shape[1]):
        carry, o = filt(carry, float(i), torch.as_tensor(seqs[:, i]))
        outs.append(o.numpy())
        counts.append(carry.count.numpy())
    return np.stack(outs, axis=1), np.stack(counts, axis=1)


# a degree-2 fit needs a window of three samples
CASES = [(k, w) for k in FILTERS for w in (1, 3, 5, 7) if not (k == "least_squares" and w < 3)]


@pytest.mark.parametrize("kind,window", CASES)
def test_filter_matches_jax_step_by_step(kind, window):
    make, tol = FILTERS[kind]
    rng = np.random.default_rng(window)
    seqs = rng.standard_normal((LANES, STEPS))
    got, got_counts = _run_port(make(tf, window), seqs)
    for lane in range(LANES):
        want, want_counts = _run_jax(make(jf, window), seqs[lane])
        np.testing.assert_allclose(got[lane], want, rtol=0, atol=tol)
        np.testing.assert_array_equal(got_counts[lane], want_counts)


def test_reference_cases():
    """``tests/test_core_periphery.py``'s cases, through the port."""
    one = lambda filt, xs: _run_port(filt, np.asarray([xs], dtype=np.float64))[0][0]
    outs = one(tf.MovingAverageFilter(window=3), [3.0, 5.0, 7.0, 9.0])
    np.testing.assert_allclose(outs[[0, 1, 3]], [3.0, 4.0, 7.0])
    outs = one(tf.MovingMedianFilter(window=3), [1.0, 100.0, 2.0, 3.0])
    np.testing.assert_allclose(outs[[2, 3]], [2.0, 3.0])
    data = [(0.5 * i ** 2 - i + 2) for i in range(8)]
    outs = one(tf.MovingLeastSquaresFilter(window=5, order=2), data)
    assert outs[-1] == pytest.approx(data[-1], abs=1e-6)


@pytest.mark.parametrize("delay", [0, 1, 2, 3])
def test_time_value_buffer_matches_jax(delay):
    nu = 2
    rng = np.random.default_rng(delay)
    us = rng.standard_normal((LANES, 6, nu))
    u_init = rng.standard_normal((LANES, nu))
    tbuf = tf.TimeValueBuffer(delay_steps=delay, nu=nu)
    carry = tbuf.init_carry(u_init=torch.as_tensor(u_init), batch_shape=(LANES,),
                            dtype=torch.float64, device="cpu")
    got = []
    for k in range(us.shape[1]):
        carry, u = tbuf.push_pop(carry, torch.as_tensor(us[:, k]))
        got.append(u.numpy())
    got = np.stack(got, axis=1)
    for lane in range(LANES):
        jbuf = jf.TimeValueBuffer(delay_steps=delay, nu=nu)
        jc = jbuf.init_carry(u_init=jnp.asarray(u_init[lane]))
        want = []
        for k in range(us.shape[1]):
            jc, u = jbuf.push_pop(jc, jnp.asarray(us[lane, k]))
            want.append(np.asarray(u))
        np.testing.assert_allclose(got[lane], np.stack(want), rtol=0, atol=1e-12)
        if delay:
            assert int(carry.filled[lane]) == int(jc.filled)


def test_time_value_buffer_reference_case():
    buf = tf.TimeValueBuffer(delay_steps=2, nu=1)
    carry = buf.init_carry(u_init=torch.zeros(1, dtype=torch.float64), dtype=torch.float64,
                           device="cpu")
    applied = []
    for k in range(5):
        carry, u = buf.push_pop(carry, torch.tensor([float(k + 1)], dtype=torch.float64))
        applied.append(float(u[0]))
    assert applied == [0.0, 0.0, 1.0, 2.0, 3.0]
