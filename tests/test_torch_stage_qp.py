"""PyTorch port vs JAX package: solvers/stage_qp.py in float64.

The random QPs of tests/test_admm_pallas.py (Kst=9, nz=4, nc=2, B=4), made
with numpy from a seed and handed to both sides. Tolerance 1e-10 where both
sides run the same recurrences at a fixed iteration count; the multi-round
case allows 1e-8 because the per-lane ρ adaptation (a sqrt of a ratio of
residuals) feeds rounding differences back into later rounds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.solvers import stage_qp as jqp
from control_box_rst_tpu_torch import convert
from control_box_rst_tpu_torch.solvers import stage_qp as tqp

from torch_port_util import jax_stage_qp, random_qp_batch_np, random_qp_np, to_np

torch.set_num_threads(1)
TOL = 1e-10
SEEDS = (10, 11, 12, 13)


def test_assemble_M_matches_jax():
    d = random_qp_np(7)
    cfg_j, cfg_t = jqp.QPConfig(), tqp.QPConfig()
    rho_eq = 37.5
    rho_box = np.where(d["dlb"] == d["dub"], rho_eq, 0.3)
    Dj, Oj = jax.jit(
        lambda qp, rb: jqp._assemble_M(qp, cfg_j, rho_eq, jnp.zeros((9, 0)), rb)
    )(jax_stage_qp(d, jnp.float64), jnp.asarray(rho_box))
    Dt, Ot = tqp._assemble_M(
        convert.stage_qp_from_numpy(d, torch.float64, "cpu"), cfg_t, rho_eq, None,
        torch.from_numpy(rho_box),
    )
    np.testing.assert_allclose(to_np(Dt), np.asarray(Dj), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(to_np(Ot), np.asarray(Oj), rtol=TOL, atol=TOL)


@pytest.mark.parametrize(
    "max_iter,per_round,tol",
    [(1, 1, 1e-8), (7, 7, 1e-8), (30, 30, 1e-8), (40, 10, 1e-8), (60, 10, 3e-3)],
    ids=["1x1", "1x7", "1x30", "4x10", "early-exit"],
)
def test_nonfused_admm_matches_jax(max_iter, per_round, tol):
    """The non-fused ADMM at fixed iteration counts; the last case has a
    tolerance loose enough that lanes leave the round loop at different
    rounds, which checks the per-lane freeze against vmap's."""
    d = random_qp_batch_np(SEEDS)
    kw = dict(max_iter=max_iter, iters_per_round=per_round, tol=tol, linsolver="scan")
    sol_j = jax.jit(jax.vmap(
        lambda qp: jqp.solve_stage_qp(qp, jqp.QPConfig(backend="xla", **kw))
    ))(jax_stage_qp(d, jnp.float64))
    sol_t = tqp.solve_stage_qp(
        convert.stage_qp_from_numpy(d, torch.float64, "cpu"), tqp.QPConfig(**kw)
    )
    tol_cmp = TOL if max_iter == per_round else 1e-8
    for name in ("delta", "y_dyn", "y_box", "prim_res", "dual_res"):
        np.testing.assert_allclose(
            to_np(getattr(sol_t, name)), np.asarray(getattr(sol_j, name)),
            rtol=tol_cmp, atol=tol_cmp, err_msg=name,
        )
    np.testing.assert_array_equal(to_np(sol_t.iters), np.asarray(sol_j.iters))
    assert sol_t.iters.dtype == torch.int32
    if tol > 1e-4:
        assert len(set(to_np(sol_t.iters).tolist())) > 1, "lanes should exit apart"


def test_nonfused_admm_warm_start_and_unbatched():
    d = random_qp_np(21)
    rng = np.random.default_rng(5)
    warm = dict(
        delta=rng.standard_normal((9, 4)) * 0.1, y_dyn=rng.standard_normal((8, 2)),
        y_gen=np.zeros((9, 0)), y_box=rng.standard_normal((9, 4)) * 0.1,
    )
    kw = dict(max_iter=12, iters_per_round=6, tol=1e-12)
    sol_j = jax.jit(
        lambda qp, w: jqp.solve_stage_qp(qp, jqp.QPConfig(backend="xla", **kw), w)
    )(
        jax_stage_qp(d, jnp.float64),
        jqp.QPWarmStart(**{k: jnp.asarray(v) for k, v in warm.items()}),
    )
    sol_t = tqp.solve_stage_qp(
        convert.stage_qp_from_numpy(d, torch.float64, "cpu"), tqp.QPConfig(**kw),
        convert.qp_warm_start_from_numpy(warm, torch.float64, "cpu"),
    )
    np.testing.assert_allclose(to_np(sol_t.delta), np.asarray(sol_j.delta), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(to_np(sol_t.y_box), np.asarray(sol_j.y_box), rtol=1e-8, atol=1e-8)
    assert int(sol_t.iters) == int(sol_j.iters) == 12


def test_dense_oracle_matches_jax_and_admm():
    """dense_qp_oracle against JAX's, and the converged ADMM against it on a
    QP whose box inequalities are inactive (1e-6: ADMM tolerance 1e-9 times
    the conditioning of the penalized pins)."""
    d = random_qp_np(33)
    d["dlb"][d["dlb"] < 0] = -50.0
    d["dub"][d["dub"] > 0] = 50.0
    delta_j, lam_j = jax.jit(jqp.dense_qp_oracle)(jax_stage_qp(d, jnp.float64))
    qp_t = convert.stage_qp_from_numpy(d, torch.float64, "cpu")
    delta_t, lam_t = tqp.dense_qp_oracle(qp_t)
    np.testing.assert_allclose(to_np(delta_t), np.asarray(delta_j), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(to_np(lam_t), np.asarray(lam_j), rtol=1e-8, atol=1e-8)
    sol = tqp.solve_stage_qp(
        qp_t, tqp.QPConfig(max_iter=600, iters_per_round=50, tol=1e-9)
    )
    np.testing.assert_allclose(to_np(sol.delta), to_np(delta_t), rtol=1e-6, atol=1e-6)


def test_unported_options_are_refused():
    d = random_qp_np(1)
    qp_t = convert.stage_qp_from_numpy(d, torch.float64, "cpu")
    # 'bcr' is ported (the other-grids slice); an unknown name raises
    with pytest.raises(KeyError):
        tqp.solve_stage_qp(qp_t, tqp.QPConfig(linsolver="cyclic"))
    with pytest.raises(KeyError):
        tqp.solve_stage_qp(qp_t, tqp.QPConfig(backend="xla"))
    with_rows = qp_t.replace(
        G=torch.zeros((9, 1, 4), dtype=torch.float64),
        gl=torch.zeros((9, 1), dtype=torch.float64),
        gu=torch.zeros((9, 1), dtype=torch.float64),
    )
    # general rows: the non-fused ADMM takes them since the constrained
    # slice; the fused route (box QPs only) refuses them by name
    assert bool(torch.isfinite(tqp.solve_stage_qp(with_rows, tqp.QPConfig()).delta).all())
    with pytest.raises(NotImplementedError, match="general rows"):
        tqp.solve_stage_qp(
            convert.stage_qp_from_numpy(dict(d, G=np.zeros((9, 1, 4)), gl=np.zeros((9, 1)),
                                             gu=np.zeros((9, 1))), torch.float32, "cpu"),
            tqp.QPConfig(backend="fused"))


def test_fused_backend_refuses_float64():
    """'fused' is the float32 kernel path by name: asked for on float64 data
    it raises and never hands the solve to the non-fused ADMM, whether
    through ``solve_stage_qp`` or through the SQP's one-shot branch."""
    from control_box_rst_tpu_torch.entry import flagship
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    qp_t = convert.stage_qp_from_numpy(random_qp_np(1), torch.float64, "cpu")
    with pytest.raises(TypeError, match="float32"):
        tqp.solve_stage_qp(qp_t, tqp.QPConfig(backend="fused"))
    ocp, cfg = flagship(N=4, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))
    solver = make_batched_solver(ocp, cfg, device="cpu", dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        solver(np.zeros((2, 2)))
