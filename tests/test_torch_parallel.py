"""The port's device mesh on the CPU, across real processes.

``parallel/mesh.py`` and the ``mesh=`` paths of ``make_batched_solver``,
``make_batched_closed_loop`` and ``benchmark_varying_initial_state`` in 2 and
4 gloo ranks spawned with ``torch.multiprocessing`` (``spawn_ranks``: a
``file://`` store under the test's ``tmp_path``, one thread a rank, a join
timeout on every spawn), all in float64, against the same work without a
mesh in this process (atol 1e-10) and against the JAX package's sharded
solve and sweep on its 8-device virtual CPU mesh (``tests/conftest.py``).

Tolerances against JAX: the solve (the reference's
``test_sharded_batch_solve_matches_single_device``, QPs at tol 1e-10) at U
atol 1e-7 and objective rtol 1e-9, those of the port's float64 config-1
comparison (``tests/test_torch_sqp_slice.py::test_outer_loop_only_matches_jax``);
the noise-free sweep at 1e-6 on every field, that of the port's whole
closed-loop runs against JAX (``tests/test_torch_closed_loop_runs.py``).
The noisy runs are held to the unsharded port only: the reference draws
per-lane ``jax.random`` keys, the port one seeded ``torch.Generator``.
"""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

import torch_parallel_ranks as tr
from control_box_rst_tpu.control import PredictiveController as JaxController
from control_box_rst_tpu.models import DoubleIntegratorContinuous as JaxDI
from control_box_rst_tpu.parallel import make_batched_solver as jax_make_batched_solver
from control_box_rst_tpu.parallel import make_mesh as jax_make_mesh
from control_box_rst_tpu.parallel import pad_to_multiple as jax_pad_to_multiple
from control_box_rst_tpu.parallel import shard_batch as jax_shard_batch
from control_box_rst_tpu.sim import SimulatedPlant as JaxPlant
from control_box_rst_tpu.sim.benchmarks import (
    benchmark_varying_initial_state as jax_benchmark_varying_initial_state,
)
from control_box_rst_tpu.solvers import QPConfig as JaxQPConfig
from control_box_rst_tpu.solvers import SQPConfig as JaxSQPConfig
from control_box_rst_tpu_torch.parallel import batch_sharding, make_mesh, pad_to_multiple, replicated
from control_box_rst_tpu_torch.parallel.mesh import spawn_ranks

from torch_port_util import jax_flagship

torch.set_num_threads(1)
WORLDS = (2, 4)
SPAWN_TIMEOUT_S = 120


def _jax_cfg(settings):
    return JaxSQPConfig(qp=JaxQPConfig(**settings["qp"]),
                        **{k: v for k, v in settings.items() if k != "qp"})


def _jax_sharded():
    """The JAX package's sharded solve (the reference's test) and its
    noise-free sweep, each on its 8-device virtual mesh."""
    assert jax.device_count() == 8
    mesh = jax_make_mesh()
    ocp, _ = jax_flagship(tr.SOLVE_N, jnp.float64)
    solve = jax_make_batched_solver(ocp, _jax_cfg(tr.SOLVE_CFG), dt_init=0.1, mesh=mesh)
    U, obj, status, iters = solve(jax_shard_batch(jnp.asarray(tr.solve_x0s()), mesh))
    assert len(U.sharding.device_set) == 8
    jctrl = JaxController(nx=2, nu=1, ocp=jax_flagship(tr.LOOP_N, jnp.float64)[0],
                          dt=tr.LOOP_DT, cfg=_jax_cfg(tr.LOOP_CFG))
    sweep, x0s = jax_benchmark_varying_initial_state(
        JaxPlant(system=JaxDI()), jctrl, jnp.asarray(tr.SWEEP_X01), jnp.asarray(tr.SWEEP_X02),
        tr.LOOP_T, tr.LOOP_DT, mesh=mesh)
    fields = {f: np.asarray(getattr(sweep, f))
              for f in ("ts", "x_true", "y", "x_observed", "u", "ok")}
    fields.update({f"info.{k}": np.asarray(v) for k, v in sweep.info.items()})
    return dict(solve=[np.asarray(a) for a in (U, obj, status, iters)], sweep=fields,
                sweep_x0s=np.asarray(x0s))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 2- and the 4-rank job, run while this process computes the
    unsharded port's and the JAX package's results: ({world: what each rank
    returned}, unsharded, JAX)."""
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        jobs = {w: pool.submit(spawn_ranks, tr.body, w, device_type="cpu",
                               timeout_s=SPAWN_TIMEOUT_S,
                               workdir=str(tmp_path_factory.mktemp(f"mesh{w}")))
                for w in WORLDS}
        unsharded, jax_sharded = tr.unsharded(), _jax_sharded()
        return {w: job.result() for w, job in jobs.items()}, unsharded, jax_sharded


@pytest.fixture(params=WORLDS)
def ranks(request, runs):
    return request.param, runs[0][request.param]


@pytest.fixture
def unsharded(runs):
    return runs[1]


@pytest.fixture
def jax_sharded(runs):
    return runs[2]


def _assert_fields_close(got, want, atol):
    assert set(got) == set(want)
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=0, atol=atol, err_msg=name)


def test_sharded_batch_solve_matches_single_device(ranks, unsharded, jax_sharded):
    world, out = ranks
    U, obj, status, iters = out[0]["solve"]
    U_l, obj_l, status_l, iters_l = unsharded["solve"]
    for r in out:  # every rank gathers the same batch
        for a, b in zip(r["solve"], out[0]["solve"]):
            np.testing.assert_array_equal(a, b)
    assert U.shape == (tr.SOLVE_B, tr.SOLVE_N, 1) and U.dtype == np.float64
    np.testing.assert_allclose(U, U_l, rtol=0, atol=1e-10)
    np.testing.assert_allclose(obj, obj_l, rtol=0, atol=1e-10)
    np.testing.assert_array_equal(status, status_l)
    np.testing.assert_array_equal(iters, iters_l)
    U_j, obj_j, status_j, _ = jax_sharded["solve"]
    np.testing.assert_allclose(U, U_j, rtol=0, atol=1e-7)
    np.testing.assert_allclose(obj, obj_j, rtol=1e-9)
    np.testing.assert_array_equal(status, status_j)
    assert all(r["full_tensor_equal"] for r in out)


def test_sharded_solution_is_partitioned(ranks):
    world, out = ranks
    for r in out:
        assert r["world"] == world and all(r["placements"])
        assert r["local_lanes"]["solve"] == [tr.SOLVE_B // world] * 4
        assert r["local_lanes"]["partitioned"] == [8 // world] * 4
        assert r["local_lanes"]["closed_loop"] == tr.LOOP_B // world


def test_sharded_closed_loop_equals_unsharded_with_noise(ranks, unsharded):
    world, out = ranks
    got = out[0]["closed_loop"]
    _assert_fields_close(got, unsharded["closed_loop"], atol=1e-10)
    # the noise is there: the measured output differs from the true state
    assert np.abs(got["y"] - got["x_true"][:, :-1]).max() > 1e-3


def test_sharded_sweep_equals_unsharded_and_jax(ranks, unsharded, jax_sharded):
    world, out = ranks
    _assert_fields_close(out[0]["sweep"], unsharded["sweep"], atol=1e-10)
    np.testing.assert_array_equal(out[0]["sweep_x0s"], jax_sharded["sweep_x0s"])
    _assert_fields_close(out[0]["sweep_noise_free"], jax_sharded["sweep"], atol=1e-6)


def test_uneven_batch_raises(ranks):
    world, out = ranks
    for r in out:
        assert r["uneven_raises"] == [True, True, True]


@pytest.mark.parametrize("n,multiple", [(9, 8), (16, 8), (7, 4), (3, 2)])
def test_pad_to_multiple_matches_reference(n, multiple):
    x = np.random.default_rng(n).standard_normal((n, 2, 3))
    got, n_pad = pad_to_multiple(x, multiple)
    want, n_pad_j = jax_pad_to_multiple(x, multiple)
    assert n_pad == n_pad_j and (n + n_pad) % multiple == 0
    np.testing.assert_array_equal(got, np.asarray(want))


def test_one_rank_mesh_path(unsharded):
    """``make_mesh`` in a process with no group makes the one-rank mesh (the
    reference's one-chip mesh): the sharded solve is the unsharded one."""
    import torch.distributed as dist

    from control_box_rst_tpu_torch.entry import flagship
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.size() == 1 and dist.get_backend() == "gloo"
        ocp, _ = flagship(N=tr.SOLVE_N, **tr.F64)
        outs = make_batched_solver(ocp, tr.sqp_cfg(tr.SOLVE_CFG), dt_init=0.1, mesh=mesh,
                                   **tr.F64)(tr.solve_x0s())
        for o, want in zip(outs, unsharded["solve"]):
            assert o.to_local().shape[0] == tr.SOLVE_B
            np.testing.assert_array_equal(o.to_local().numpy(), want)
        assert batch_sharding(mesh) == (Shard(0),) and replicated(mesh) == (Replicate(),)
        with pytest.raises(ValueError):  # the device is the mesh's
            make_batched_solver(ocp, mesh=mesh, device="cuda")
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_runs(ranks):
    """Every rank ran ``entry.dryrun_multichip(world)`` (its asserts inside)."""
    world, out = ranks
    assert [r["world"] for r in out] == [world] * world


def test_a_hung_or_failing_rank_fails_the_spawn(tmp_path):
    with pytest.raises(TimeoutError):
        spawn_ranks(tr.hang, 1, device_type="cpu", timeout_s=1, workdir=str(tmp_path / "a"))
    with pytest.raises(Exception, match="rank 0 fails"):
        spawn_ranks(tr.fail, 1, device_type="cpu", timeout_s=SPAWN_TIMEOUT_S,
                    workdir=str(tmp_path / "b"))
