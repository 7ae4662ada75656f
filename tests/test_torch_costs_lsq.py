"""PyTorch port vs JAX package: the least-squares form of the costs
(``stage_residual`` / ``final_residual``, ``_sqrtm_psd``).

Same numpy inputs from a seed through both, float64, tolerance 1e-12: one
eigendecomposition of a small PSD matrix and a product on either side. The
JAX side runs under ``jax.jit``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ocp import costs as jc
from control_box_rst_tpu_torch.ocp import costs as tc

from torch_port_util import to_np

torch.set_num_threads(1)
TOL = 1e-12
NX, NU, LEAD = 3, 2, (4, 5)


def _psd(rng, n, rank=None):
    A = rng.standard_normal((n, rank or n))
    return A @ A.T


def _mats(seed):
    rng = np.random.default_rng(seed)
    return _psd(rng, NX), _psd(rng, NU), _psd(rng, NX)


def _points(seed):
    rng = np.random.default_rng(seed + 100)
    return (rng.standard_normal(LEAD + (NX,)), rng.standard_normal(LEAD + (NU,)),
            rng.uniform(0.05, 0.2, LEAD), rng.standard_normal(LEAD + (NX,)),
            rng.standard_normal(LEAD + (NU,)))


def _costs(seed):
    Q, R, Qf = _mats(seed)
    j = lambda a: jnp.asarray(a)
    t = lambda a: torch.from_numpy(a)
    return {
        "base": (jc.StageCost(), tc.StageCost()),
        "form": (jc.QuadraticFormCost(Q=j(Q), R=j(R)), tc.QuadraticFormCost(Q=t(Q), R=t(R))),
        "final": (jc.QuadraticFinalStateCost(Qf=j(Qf)), tc.QuadraticFinalStateCost(Qf=t(Qf))),
        "composite": (
            jc.CompositeCost(costs=(jc.QuadraticFormCost(Q=j(Q), R=j(R)),
                                    jc.QuadraticFinalStateCost(Qf=j(Qf)))),
            tc.CompositeCost(costs=(tc.QuadraticFormCost(Q=t(Q), R=t(R)),
                                    tc.QuadraticFinalStateCost(Qf=t(Qf)))),
        ),
    }


def _over_lead(fn, n_args):
    for _ in LEAD:
        fn = jax.vmap(fn, in_axes=(0,) * n_args)
    return jax.jit(fn)


@pytest.mark.parametrize("seed", [0, 1])
def test_sqrtm_psd_matches_jax(seed):
    for M in _mats(seed):
        want = np.asarray(jax.jit(jc._sqrtm_psd)(jnp.asarray(M)))
        got = to_np(tc._sqrtm_psd(torch.from_numpy(M)))
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
        np.testing.assert_allclose(got @ got, M, rtol=0, atol=1e-11)


def test_sqrtm_psd_of_a_singular_matrix():
    """A zero eigenvalue comes out of eigh as ±1e-16 and is clamped at 0; its
    root is only good to 1e-8 on either side, so the tolerance is 1e-7."""
    M = _psd(np.random.default_rng(7), NX, rank=2)
    want = np.asarray(jax.jit(jc._sqrtm_psd)(jnp.asarray(M)))
    got = to_np(tc._sqrtm_psd(torch.from_numpy(M)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    np.testing.assert_allclose(got @ got, M, rtol=0, atol=1e-11)


@pytest.mark.parametrize("kind", ["base", "form", "final", "composite"])
def test_stage_residual_matches_jax(kind):
    cj, ct = _costs(0)[kind]
    x, u, dt, xref, uref = _points(0)
    want = np.asarray(_over_lead(cj.stage_residual, 5)(
        *(jnp.asarray(a) for a in (x, u, dt, xref, uref))))
    got = ct.stage_residual(*(torch.from_numpy(a) for a in (x, u, dt, xref, uref)))
    assert got.dtype == torch.float64 and got.shape == want.shape
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=TOL)
    if kind in ("form", "composite"):  # cost = r'r
        cost = ct.stage(*(torch.from_numpy(a) for a in (x, u, dt, xref, uref)))
        np.testing.assert_allclose(to_np((got ** 2).sum(-1)), to_np(cost), rtol=1e-12)


@pytest.mark.parametrize("kind", ["base", "form", "final", "composite"])
def test_final_residual_matches_jax(kind):
    cj, ct = _costs(1)[kind]
    x, _, _, xref, _ = _points(1)
    want = np.asarray(_over_lead(cj.final_residual, 2)(jnp.asarray(x), jnp.asarray(xref)))
    got = ct.final_residual(torch.from_numpy(x), torch.from_numpy(xref))
    assert got.shape == want.shape
    np.testing.assert_allclose(to_np(got), want, rtol=0, atol=TOL)
    if kind in ("final", "composite"):
        cost = ct.final(torch.from_numpy(x), torch.from_numpy(xref))
        np.testing.assert_allclose(to_np((got ** 2).sum(-1)), to_np(cost), rtol=1e-11)


def test_square_roots_follow_the_object_across_dtype_and_device_copies():
    """The roots are taken when a cost object is built, so a copy in another
    dtype carries roots of its own weights in its own dtype."""
    from control_box_rst_tpu_torch.utils.tree import tree_to

    _, ct = _costs(0)["composite"]
    c32 = tree_to(ct, "cpu", torch.float32)
    form64, form32 = ct.costs[0], c32.costs[0]
    assert form64._Qs.dtype == torch.float64 and form32._Qs.dtype == torch.float32
    np.testing.assert_allclose(to_np(form32._Qs), to_np(form64._Qs), rtol=0, atol=1e-6)
    x, u, dt, xref, uref = (torch.from_numpy(a).float() for a in _points(0))
    assert c32.stage_residual(x, u, dt, xref, uref).dtype == torch.float32
