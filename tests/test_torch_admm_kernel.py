"""PyTorch port vs JAX package: the kernel-bearing module
ops/cuda/admm_kernel.py, float32, on the CPU.

The CUDA kernels cannot run here (no card, no nvcc): on a CPU tensor each
wrapper takes its plain version, and that is what these tests hold against
the JAX package — against the per-lane references of solvers/stage_qp.py
under ``jax.vmap`` here, and against the Pallas kernel in interpret mode in
tests/test_torch_admm_pallas_interpret.py (a file of its own: the interpreted
kernel takes over a minute). The kernels themselves are held against the
plain versions on the card by ``chip_smoke.py``.

Tolerances are those the JAX package uses for its own kernel-vs-XLA test
(tests/test_admm_pallas.py): x rtol 2e-4 / atol 2e-5, duals rtol 2e-3 /
atol 3e-3 — float32 roundoff of two orderings of the same recurrences,
amplified by ρ_eq = 10³ρ in the duals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.solvers import stage_qp as jqp
from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
from control_box_rst_tpu_torch.ops.cuda import layout
from control_box_rst_tpu_torch.solvers import stage_qp as tqp

from torch_port_util import kernel_args_np, random_qp_batch_np, to_np

torch.set_num_threads(1)
X_TOL = dict(rtol=2e-4, atol=2e-5)
DUAL_TOL = dict(rtol=2e-3, atol=3e-3)
RES_TOL = dict(rtol=1e-2, atol=1e-4)
SEEDS = (10, 11, 12, 13)
BASE = dict(sigma=1e-6, alpha=1.6, rho_eq_scale=1e3)


def _args(rho=0.1, seeds=SEEDS):
    a = kernel_args_np(random_qp_batch_np(seeds), rho, np.float32)
    return a, [jnp.asarray(x) for x in a], [torch.from_numpy(x) for x in a]


def _cmp_round(out_t, out_j):
    for i, tol in ((0, X_TOL), (1, X_TOL), (2, DUAL_TOL), (3, DUAL_TOL),
                   (4, RES_TOL), (5, RES_TOL)):
        np.testing.assert_allclose(to_np(out_t[i]), np.asarray(out_j[i]), **tol)


@pytest.mark.parametrize("iters", [1, 7])
def test_admm_round_plain_vs_jax_reference(iters):
    _, aj, at = _args()
    ref = jqp._round_reference_fn(jqp.QPConfig(), iters)
    out_j = jax.jit(jax.vmap(ref))(*aj)
    out_t = ak.admm_round_plain(*at, iters=iters, **BASE)
    assert out_t[0].dtype == torch.float32
    _cmp_round(out_t, out_j)
    # the port's own stage_qp-level closure is the same function
    out_t2 = tqp._round_reference_fn(tqp.QPConfig(), iters)(*at)
    for a, b in zip(out_t, out_t2):
        np.testing.assert_array_equal(to_np(a), to_np(b))


SOLVE_CFG = dict(iters_per_round=10, rho=0.1, tol=2e-4)
MAX_ITER = 80


@pytest.mark.parametrize("kkt", [None, (5e-4, 5e-5)], ids=["admm-exit", "kkt-exit"])
def test_boxqp_solve_plain_vs_jax_reference(kkt):
    """Full solve with the production exit tests, per-lane semantics on both
    sides: same per-lane `it`, x within 1e-4 (the exits leave ~tol of ADMM
    error in x; the two sides leave at the same round, so they differ by
    float32 roundoff compounded over the rounds)."""
    seeds = tuple(range(40, 48))
    _, aj, at = _args(rho=SOLVE_CFG["rho"], seeds=seeds)
    cfg_j = jqp.QPConfig(kkt_tols=kkt, **SOLVE_CFG)
    _, ref = jqp._make_fused_solve(cfg_j, MAX_ITER, cfg_j.tol)
    out_j = jax.jit(jax.vmap(ref))(*aj)
    cfg_t = tqp.QPConfig(kkt_tols=kkt, **SOLVE_CFG)
    fused, ref_t = tqp._make_fused_solve(cfg_t, MAX_ITER, cfg_t.tol)
    out_t = ref_t(*at)
    np.testing.assert_array_equal(to_np(out_t[6]), np.asarray(out_j[6]))
    assert len(set(to_np(out_t[6]).tolist())) > 1, "lanes should exit apart"
    assert float(out_t[6].max()) < MAX_ITER, "some lane should exit early"
    np.testing.assert_allclose(to_np(out_t[0]), np.asarray(out_j[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(out_t[2]), np.asarray(out_j[2]), **DUAL_TOL)
    np.testing.assert_allclose(to_np(out_t[3]), np.asarray(out_j[3]), **DUAL_TOL)
    # on CPU tensors the dispatching wrapper IS the plain version
    out_w = fused(*at)
    for a, b in zip(out_t, out_w):
        np.testing.assert_array_equal(to_np(a), to_np(b))


def test_wrappers_on_cpu_take_plain_version_and_count_no_launch():
    _, _, at = _args()
    ak.reset_launch_counts()
    out_w = ak.admm_round(*at, iters=3, **BASE)
    out_p = ak.admm_round_plain(*at, iters=3, **BASE)
    for a, b in zip(out_w, out_p):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    kw = dict(n_rounds=3, iters=4, tol=1e-5, rho_min=1e-4, rho_max=1e4, **BASE)
    out_w = ak.boxqp_solve(*at, **kw)
    out_p = ak.boxqp_solve_plain(*at, **kw)
    for a, b in zip(out_w, out_p):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert ak.LAUNCHES == {"boxqp_solve": 0, "admm_round": 0}


def test_wrappers_refuse_malformed_operands():
    _, _, at = _args()
    bad = list(at)
    bad[3] = bad[3][:, :-1]  # g with a stage missing
    with pytest.raises(ValueError):
        ak.admm_round(*bad, iters=1, **BASE)
    bad = list(at)
    bad[7] = bad[7].double()  # mixed dtypes
    with pytest.raises(ValueError):
        ak.boxqp_solve(*bad, n_rounds=1, iters=1, tol=0.0, rho_min=1e-4,
                       rho_max=1e4, **BASE)
    with pytest.raises(ValueError):
        ak.admm_round(*at, iters=0, **BASE)


def test_fused_backend_of_solve_stage_qp_vs_jax():
    """solve_stage_qp(backend='fused') on the CPU (plain version behind the
    dispatch) vs the JAX fused backend called unbatched per lane (its
    per-lane reference)."""
    d = random_qp_batch_np(SEEDS)
    kw = dict(max_iter=40, iters_per_round=10, tol=2e-4, rho=0.1)
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    solve_j = jax.jit(
        lambda qp: jqp.solve_stage_qp(qp, jqp.QPConfig(backend="fused", **kw))
    )
    sols_j = [
        solve_j(jqp.StageQP(**{k: f32(v[i]) for k, v in d.items()}))
        for i in range(len(SEEDS))
    ]
    from control_box_rst_tpu_torch import convert

    sol_t = tqp.solve_stage_qp(
        convert.stage_qp_from_numpy(d, torch.float32, "cpu"), tqp.QPConfig(backend="fused", **kw)
    )
    assert sol_t.iters.dtype == torch.int32
    for i, sj in enumerate(sols_j):
        assert int(sol_t.iters[i]) == int(sj.iters)
        np.testing.assert_allclose(to_np(sol_t.delta[i]), np.asarray(sj.delta), rtol=0, atol=1e-4)
        np.testing.assert_allclose(to_np(sol_t.y_box[i]), np.asarray(sj.y_box), **DUAL_TOL)


def test_work_counts_scale_with_the_loops():
    """The roofline counters follow the kernel's loops: linear in iterations
    beyond the factorization, linear in lanes for the bytes."""
    f1, f2, f3 = (ak.round_flops(51, 4, 2, n) for n in (1, 2, 3))
    assert f3 - f2 == f2 - f1 > 0
    assert ak.solve_flops_per_round(51, 4, 2, 12, True) > ak.solve_flops_per_round(51, 4, 2, 12, False) > ak.round_flops(51, 4, 2, 12)
    assert ak.io_bytes(51, 4, 2, 64, True) == 2 * ak.io_bytes(51, 4, 2, 32, True)
    # inputs 3041 + outputs 715 floats per lane at flagship shapes, of which
    # Hd, J, K are 1616; shared, they are counted once for the batch
    assert ak.io_bytes(51, 4, 2, 1, True) == 4 * (3041 + 715)
    assert ak.io_bytes(51, 4, 2, 10, True, shared_hjk=True) == 4 * (10 * (3041 - 1616 + 715) + 1616)


@pytest.mark.parametrize("B", [1, 31, 32, 70])
def test_kernel_lane_layout_round_trip_and_addressing(B):
    """The layout the wrappers hand to the CUDA kernels (Python the CPU tests
    can reach): element (idx, lane) sits where lane_offset() of the csrc/*.cu
    sources looks for it, ragged last tiles included."""
    T, rows = layout.lane_tile(B), 15
    assert T == (32 if B >= 32 else 1)
    a = torch.randn(B, 5, 3)
    k = layout.to_kernel_layout(a)
    assert k.is_contiguous() and k.numel() == rows * layout.padded_lanes(B)
    flat, a2 = k.reshape(-1), a.reshape(B, rows)
    for lane in {0, B // 2, B - 1}:
        for idx in (0, 7, rows - 1):
            assert flat[(lane // T * rows + idx) * T + lane % T] == a2[lane, idx]
    assert torch.equal(layout.from_kernel_layout(k, a.shape), a)


def test_lane_invariant_structure_is_passed_once():
    _, _, at = _args()
    ops, shared = ak._kernel_operands(at)
    assert not shared and ops[1].numel() == at[1][0].numel() * layout.padded_lanes(len(SEEDS))
    ex = [a[0].expand(a.shape) for a in at[:3]] + list(at[3:])
    ops, shared = ak._kernel_operands(ex)
    assert shared
    for o, a in zip(ops[:3], at[:3]):
        assert torch.equal(o, a[0].reshape(-1))
    assert ops[3].numel() == at[3][0].numel() * layout.padded_lanes(len(SEEDS))


@pytest.mark.parametrize("shape", [(51, 4, 2), (21, 3, 1), (101, 6, 3)],
                         ids=lambda s: "Kst{}_nz{}_nc{}".format(*s))
def test_resident_lanes_follow_the_state_size(shape):
    """The shared-memory route holds whole warps of `LANES_PER_WARP` lanes in
    the 227 KB of a block; a lane's own J and K cost residency."""
    per_warp = ak.LANES_PER_WARP
    shared = ak.resident_lanes_per_sm(*shape, True)
    per_lane = ak.resident_lanes_per_sm(*shape, False)
    assert shared % per_warp == 0 and per_lane % per_warp == 0
    assert 0 < per_lane < shared
    assert shared * ak.state_bytes_per_lane(*shape, True) <= ak.MAX_DYNAMIC_SMEM_BYTES
    assert (shared + per_warp) * ak.state_bytes_per_lane(*shape, True) > ak.MAX_DYNAMIC_SMEM_BYTES


@pytest.mark.parametrize("route", ["smem", "thread"])
def test_naming_a_route_changes_nothing_on_the_cpu(route):
    """`route` names a kernel of the card; a CPU tensor takes the plain
    version whatever it says, and no launch is recorded."""
    _, _, at = _args()
    ak.reset_launch_counts()
    before = {k: dict(v) for k, v in ak.LAUNCH_INFO.items()}
    out_w = ak.admm_round(*at, iters=2, **BASE, route=route)
    for a, b in zip(out_w, ak.admm_round_plain(*at, iters=2, **BASE)):
        np.testing.assert_array_equal(to_np(a), to_np(b))
    assert ak.LAUNCHES == {"boxqp_solve": 0, "admm_round": 0}
    assert ak.LAUNCH_INFO == before
    with pytest.raises(ValueError):
        ak.admm_round(*at, iters=0, **BASE, route=route)


def test_division_check_is_for_the_card_only():
    with pytest.raises(ValueError):
        ak.division_mismatches(torch.ones(4), torch.ones(4), 4, 2)
