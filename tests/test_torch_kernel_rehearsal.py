"""PyTorch port: the CUDA sources rehearsed on the CPU.

The kernels of ``control_box_rst_tpu_torch/csrc/`` run on the card only, and
``chip_smoke.py`` holds them against their plain versions there. What can be
held here is their arithmetic and their control flow: ``tools/cuda_host_shim``
compiles a ``.cu`` file as host C++ (a block's threads are real threads, a
warp's ``__syncwarp`` and shuffles go through a barrier), and the wrappers'
own launch code drives the result with CPU tensors. Held together here, on
the same numpy inputs from a seed, float32:

  * the shared-memory kernels (a team of threads per lane, persistent blocks,
    lanes handed out by an atomic counter) against the one-thread-per-lane
    kernels: same statements in the same order and no FMA contraction on the
    host, so the same bits; so does K3's kernel (one thread per lane, the
    factor in a scratch);
  * both against the plain PyTorch versions (x atol 1e-4 over a few ρ-adapted
    rounds, the per-lane ``it`` equal; 5e-6 for the block-tridiagonal solve,
    the bound of tests/test_torch_btridiag_kernel.py).

The box-QP kernels are built for the three (nz, nc) specialisations that the
ported configurations launch: (4, 2) (configs 1, 2, 5 and 6), (4, 3)
(config 3, whose dt tie adds an interval row, and move blocking, whose u
tie does), the latter also at config 3's horizon (Kst = 21) with Hd, J, K
per lane as its SQP iterations hand them over, and (6, 4) (config 6 on the
uncompressed Hermite-Simpson grid: the midpoint states in the stage vector,
their interpolation rows among the interval rows). The (6, 4) build runs
config 6's uncompressed first-iteration QPs (Kst = 21, Hd/J/K per lane)
against the plain version, and move blocking's one-shot runs through the
(4, 3) build on one shared copy of Hd/J/K. The (5, 2) and (5, 3) builds
serve the config loader's model zoo (two controls, or three states: the
parallel integrators and the rocket) and run random QPs against the plain
version; the loader's fused path (config 1's YAML) runs through the (4, 2)
build in ``test_torch_kernel_rehearsal_loader.py``.

The block-tridiagonal source is built for nz = 4 (LM's Gauss-Newton
systems), 3 and 2 (the interior-point solver's Schur systems, nc × nc blocks
with nc = 2: 16 lanes to a warp), and the IP paths are driven through the
nz = 2 build: config 1 and the constrained double integrator by
``ip_solve``, the constrained double integrator by LM through the nz = 4
build, and the IP controller, each counting one launch per lock-step
iteration — the per-path counts ``chip_smoke.py`` holds on the card.

Skipped where there is no g++.
"""
import ctypes
import shutil

import numpy as np
import pytest
import torch

from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak
from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk
from torch_kernel_util import misaligned

torch.set_num_threads(1)
NZ, NC = 4, 2
SHAPES = ((4, 2), (4, 3), (6, 4), (5, 2), (5, 3))  # (nz, nc) of the box-QP library builds
BASE = (1e-6, 1.6, 1e3)  # sigma, alpha, rho_eq_scale


def _shim_build():
    import importlib.util
    import pathlib

    path = pathlib.Path(__file__).resolve().parents[1] / "tools" / "cuda_host_shim" / "build.py"
    spec = importlib.util.spec_from_file_location("cuda_host_shim_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.build


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    if shutil.which("g++") is None:
        pytest.skip("no g++: the CUDA sources cannot be rehearsed on this machine")
    build = _shim_build()
    out = tmp_path_factory.mktemp("cuda_host_shim")
    admm = {}
    for nz, nc in SHAPES:
        admm[nz, nc] = ctypes.CDLL(str(build(
            ak.SOURCE, out / f"libadmm_{nz}_{nc}.so", [f"-DNZ={nz}", f"-DNC={nc}"])))
        ak.declare(admm[nz, nc], nz, nc)
    bts = {}
    for nz in (4, 3, 2):
        bts[nz] = ctypes.CDLL(str(build(bk.SOURCE, out / f"libbt{nz}.so", [f"-DNZ={nz}"])))
        bk.declare(bts[nz], nz)
    return admm, bts


def _qps(B, Kst, shared, seed=0, NC=NC, NZ=NZ):
    rng = np.random.default_rng(seed)
    N = Kst - 1
    A = rng.standard_normal((B, Kst, NZ, NZ)) * 0.3
    Hd = np.einsum("bkij,bklj->bkil", A, A) + 2.0 * np.eye(NZ)
    dlb, dub = np.full((B, Kst, NZ), -0.7), np.full((B, Kst, NZ), 0.7)
    dlb[:, 0, :2] = dub[:, 0, :2] = 0.0  # pins, like a fixed initial state
    dlb[:, -1, -1] = dub[:, -1, -1] = 0.0
    z = np.zeros((B, Kst, NZ))
    arrs = [Hd, rng.standard_normal((B, N, NC, NZ)) * 0.5, rng.standard_normal((B, N, NC, NZ)) * 0.5,
            rng.standard_normal((B, Kst, NZ)), rng.standard_normal((B, N, NC)) * 0.1, dlb, dub,
            np.full((B,), 0.1), z, np.clip(z, dlb, dub), np.zeros((B, N, NC)), z]
    args = [torch.as_tensor(a, dtype=torch.float32) for a in arrs]
    if shared:
        args[:3] = [a[0].expand(a.shape) for a in args[:3]]
    return args


def _boxqp_cases():
    """(B, shared, kkt, nc, Kst) with their ids: every case at (4, 2) and
    Kst = 7, the same at nc = 3 (B = 9 left out: with shared Hd/J/K all its
    lanes leave at one round, which checks less), and config 3's horizon with
    per-lane Hd/J/K at both nc."""
    cases = []
    for nc, Kst, Bs, shareds in ((2, 7, (9, 13, 21), (False, True)),
                                 (3, 7, (13, 21), (False, True)),
                                 (2, 21, (13,), (False,)), (3, 21, (13,), (False,))):
        for B in Bs:
            for shared in shareds:
                for kkt in (False, True):
                    name = "{}-{}-{}".format(
                        B, "shared-HJK" if shared else "per-lane-HJK",
                        "kkt-exit" if kkt else "admm-exit")
                    if (nc, Kst) != (2, 7):
                        name = f"nc{nc}-Kst{Kst}-{name}"
                    cases.append(pytest.param(B, shared, kkt, nc, Kst, id=name))
    return cases


@pytest.mark.parametrize("B, shared, kkt, nc, Kst", _boxqp_cases())
def test_boxqp_solve_kernels_on_the_host(libs, B, shared, kkt, nc, Kst):
    """More lanes than the 2 persistent blocks of 2 warps have teams: teams
    take further lanes from the queue, lanes leave at different rounds."""
    admm = libs[0][NZ, nc]
    lanes_per_warp = ak.LANES_PER_WARP
    args, dims = _qps(B, Kst, shared, NC=nc), (B, Kst, NZ, nc)
    scal = (6, 4, 2e-4, *BASE, 1e-4, 1e4) + ((5e-4, 5e-5) if kkt else (0.0, 0.0))
    # a stand-in device small enough that the lanes outnumber the teams
    max_smem = ctypes.c_int.in_dll(admm, "shim_max_smem")
    max_smem.value = 2 * lanes_per_warp * ak.state_bytes_per_lane(Kst, NZ, nc, shared)
    try:
        smem = ak._launch_smem(admm, "boxqp_solve", args, dims, scal, 0)
        info = dict(ak.LAUNCH_INFO["boxqp_solve"])
    finally:
        max_smem.value = ak.MAX_DYNAMIC_SMEM_BYTES
    thread = ak._launch_thread(admm, "boxqp_solve", args, dims, scal, 0)
    plain = ak.boxqp_solve_plain(*args, *scal)
    assert info["route"] == "smem" and info["warps_per_block"] == 2 and info["blocks"] == 2
    assert info["blocks"] * info["warps_per_block"] * lanes_per_warp < B
    for a, b in zip(smem, thread):
        assert torch.equal(a, b)
    assert torch.equal(smem[6], plain[6]) and len(set(smem[6].tolist())) > 1
    np.testing.assert_allclose(smem[0].numpy(), plain[0].numpy(), rtol=0, atol=1e-4)


def _first_sqp_iteration_qps(config, B):
    """The box QPs that an outer SQP loop hands the kernel's wrapper in its
    first iteration, for the first B lanes of the chip run's batch (Hd/J/K
    per lane), caught at the wrapper, and the wrapper's scalars in argument
    order: config 2's and config 3's (Kst = 21), config 4's (Kst = 11), and
    those of one step of config 4's adaptive controller (Kst = 16), its lanes
    on different active horizons."""
    from control_box_rst_tpu_torch import entry
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    fused = lambda cfg: cfg.replace(max_iter=1, qp=cfg.qp.replace(backend="fused"))
    if config == "vdp_ms":
        ocp, cfg = entry.vdp_ms(device="cpu")
        x0s = np.random.default_rng(1).uniform(-1.5, 1.5, (4096, 2))[:B]
    elif config.startswith("hermite_simpson"):
        ocp, cfg = getattr(entry, config)(device="cpu")
        x0s = np.random.default_rng(60).uniform(-1.5, 1.5, (4096, 2))[:B]
    else:
        seed = 2 if config == "time_optimal" else 4
        d = np.random.default_rng(seed).uniform(0.5, 2.0, (4096,))[:B]
        x0s = np.stack([d, np.zeros_like(d)], axis=1)
        ocp, cfg = (entry.time_optimal(device="cpu") if config == "time_optimal"
                    else entry.nonuniform_ms_timeopt(device="cpu"))
    caught, real = [], ak.boxqp_solve
    ak.boxqp_solve = lambda *a, **kw: caught.append((a, kw)) or real(*a, **kw)
    try:
        if config == "nonuniform_adaptive_step":
            ctrl, _, _, _ = entry.nonuniform_ms_timeopt_adaptive(device="cpu")
            ctrl = ctrl.replace(cfg=fused(ctrl.cfg))
            x = torch.as_tensor(x0s, dtype=torch.float32)
            carry = ctrl.init_carry(x)
            n_active = torch.arange(B, dtype=torch.int32) % (ctrl.ocp.N - 2) + 3
            ctrl.step(carry._replace(n_active=n_active), x, 0.0, 0.1)
        else:
            make_batched_solver(
                ocp, fused(cfg), dt_init=0.12 if config == "time_optimal" else 0.1, device="cpu",
            )(x0s.astype(np.float32))
    finally:
        ak.boxqp_solve = real
    (args, kw), = caught
    keys = ("n_rounds", "iters", "tol", "sigma", "alpha", "rho_eq_scale", "rho_min",
            "rho_max", "tol_stat", "tol_feas")
    return list(args), tuple(kw[k] for k in keys)


NONLINEAR_QP_SHAPES = {  # (Kst, nc) of each path's QPs
    "vdp_ms": (21, 2), "time_optimal": (21, 3),
    "nonuniform_ms_timeopt": (11, 2), "nonuniform_adaptive_step": (16, 2),
}


@pytest.mark.parametrize("config", list(NONLINEAR_QP_SHAPES))
def test_boxqp_solve_kernel_on_nonlinear_qps_is_as_close_as_plain(libs, config):
    """The shared-memory kernel on the QPs of the nonlinear paths (config 3's
    are stiff: Hd = 0 and a dt column ~100x the others, condition ~3e5;
    config 4's adaptive step mixes horizons, its inactive intervals identity
    chains with free, cost-free dt columns) is as close to the float64 plain
    version as the float32 plain version (x, y_d, y_b, 2x + 1e-4), and takes
    the plain version's rounds. Summing J'J before the one product by rho_eq
    is what keeps it there: a product per row left config 3's duals 6x
    farther than the plain version."""
    args, scal = _first_sqp_iteration_qps(config, 32)
    B, Kst, nz = args[0].shape[:3]
    nc = args[1].shape[2]
    assert (Kst, nc) == NONLINEAR_QP_SHAPES[config]
    assert not ak._lane_invariant(*args[:3])
    kern = ak._launch_smem(libs[0][nz, nc], "boxqp_solve", args, (B, Kst, nz, nc), scal, 0)
    plain = ak.boxqp_solve_plain(*args, *scal)
    f64 = ak.boxqp_solve_plain(*[a.double() for a in args], *scal)
    assert torch.equal(kern[6], plain[6])
    for i in (0, 2, 3):
        e_k = float((kern[i].double() - f64[i]).abs().max())
        e_p = float((plain[i].double() - f64[i]).abs().max())
        assert e_k <= 2.0 * e_p + 1e-4, (i, e_k, e_p)


@pytest.mark.parametrize("config", ["hermite_simpson", "hermite_simpson_unc"])
def test_boxqp_solve_kernel_on_config6_qps(libs, config):
    """Config 6's first-iteration QPs (Kst = 21, Hd/J/K per lane, 128
    lanes; the uncompressed grid's through the (6, 4) build), as the card
    holds them: the kernel as close to the float64 plain version as the
    float32 plain version (x, y_d, y_b, 2x + 1e-4). These QPs are
    ill-conditioned in float32 (any float32 solve is 4e-3 to 7e-3 from
    float64 in x after two rounds, and which lanes are worst differs from one
    float32 solve to the other: over 32 lanes the maxima spread 3x), and
    their exit tests sit at the float32 noise floor: a lane's rounds are held
    within one of the plain version's."""
    args, scal = _first_sqp_iteration_qps(config, 128)
    B, Kst, nz = args[0].shape[:3]
    nc = args[1].shape[2]
    assert (Kst, nz, nc) == ((21, 6, 4) if config.endswith("unc") else (21, 4, 2))
    kern = ak._launch_smem(libs[0][nz, nc], "boxqp_solve", args, (B, Kst, nz, nc), scal, 0)
    plain = ak.boxqp_solve_plain(*args, *scal)
    f64 = ak.boxqp_solve_plain(*[a.double() for a in args], *scal)
    assert float((kern[6] - plain[6]).abs().max()) <= scal[1]
    for i in (0, 2, 3):
        e_k = float((kern[i].double() - f64[i]).abs().max())
        e_p = float((plain[i].double() - f64[i]).abs().max())
        assert e_k <= 2.0 * e_p + 1e-4, (i, e_k, e_p)


def test_boxqp_solve_nz6_build_on_the_host(libs):
    """The (6, 4) build on random QPs (Kst = 21, per-lane Hd/J/K, 9 lanes
    outnumbering the teams) and on config 6's uncompressed first-iteration
    QPs (13 lanes): the shared-memory kernel and the one-thread-per-lane
    kernel give the same bits; on the random QPs both take the plain
    version's rounds with x within 1e-4 of it (config 6's are held to the
    float64 plain version in ``test_boxqp_solve_kernel_on_config6_qps``)."""
    admm = libs[0][6, 4]
    for qps in ("random", "hermite_simpson_unc"):
        if qps == "random":
            B, Kst = 9, 21
            args = _qps(B, Kst, shared=False, seed=6, NC=4, NZ=6)
            scal = (6, 4, 2e-4, *BASE, 1e-4, 1e4, 0.0, 0.0)
        else:
            args, scal = _first_sqp_iteration_qps(qps, 13)
            B, Kst = args[0].shape[:2]
        dims = (B, Kst, 6, 4)
        assert ak.solve_route(Kst, 6, 4, False) == "smem"
        max_smem = ctypes.c_int.in_dll(admm, "shim_max_smem")
        max_smem.value = 2 * ak.LANES_PER_WARP * ak.state_bytes_per_lane(Kst, 6, 4, False)
        try:
            smem = ak._launch_smem(admm, "boxqp_solve", args, dims, scal, 0)
            info = dict(ak.LAUNCH_INFO["boxqp_solve"])
        finally:
            max_smem.value = ak.MAX_DYNAMIC_SMEM_BYTES
        thread = ak._launch_thread(admm, "boxqp_solve", args, dims, scal, 0)
        assert info["route"] == "smem" and not info["shared_hjk"]
        assert info["smem_bytes_per_lane"] == ak.state_bytes_per_lane(Kst, 6, 4, False)
        assert info["blocks"] * info["warps_per_block"] * ak.LANES_PER_WARP < B
        for a, b in zip(smem, thread):
            assert torch.equal(a, b)
        if qps == "random":
            plain = ak.boxqp_solve_plain(*args, *scal)
            assert torch.equal(smem[6], plain[6]) and len(set(smem[6].tolist())) > 1
            np.testing.assert_allclose(smem[0].numpy(), plain[0].numpy(), rtol=0, atol=1e-4)


@pytest.mark.parametrize("nc", [2, 3])
def test_boxqp_solve_nz5_builds_on_the_host(libs, nc):
    """The (5, nc) builds on random QPs (Kst = 21, per-lane Hd/J/K, 9 lanes
    outnumbering the teams): the shared-memory and the one-thread-per-lane
    kernels give the same bits and the plain version's rounds, x within
    1e-4 of it."""
    admm = libs[0][5, nc]
    B, Kst = 9, 21
    args = _qps(B, Kst, shared=False, seed=5 + nc, NC=nc, NZ=5)
    scal = (6, 4, 2e-4, *BASE, 1e-4, 1e4, 0.0, 0.0)
    dims = (B, Kst, 5, nc)
    max_smem = ctypes.c_int.in_dll(admm, "shim_max_smem")
    max_smem.value = 2 * ak.LANES_PER_WARP * ak.state_bytes_per_lane(Kst, 5, nc, False)
    try:
        smem = ak._launch_smem(admm, "boxqp_solve", args, dims, scal, 0)
        info = dict(ak.LAUNCH_INFO["boxqp_solve"])
    finally:
        max_smem.value = ak.MAX_DYNAMIC_SMEM_BYTES
    thread = ak._launch_thread(admm, "boxqp_solve", args, dims, scal, 0)
    assert info["route"] == "smem" and info["blocks"] * info["warps_per_block"] * ak.LANES_PER_WARP < B
    for a, b in zip(smem, thread):
        assert torch.equal(a, b)
    plain = ak.boxqp_solve_plain(*args, *scal)
    assert torch.equal(smem[6], plain[6]) and len(set(smem[6].tolist())) > 1
    np.testing.assert_allclose(smem[0].numpy(), plain[0].numpy(), rtol=0, atol=1e-4)


def test_launches_counted_by_build(libs):
    """Each launch adds one to its wrapper's count and one to the count of
    its (nz, nc) build, through both routes; a reset clears both."""
    admm = libs[0]
    scal = (2, 4, 2e-4, *BASE, 1e-4, 1e4, 0.0, 0.0)
    ak.reset_launch_counts()
    try:
        for nz, nc, route in ((5, 2, "smem"), (5, 3, "thread"), (5, 3, "smem"), (4, 2, "thread")):
            B, Kst = 3, 6
            args = _qps(B, Kst, shared=False, seed=nz + nc, NC=nc, NZ=nz)
            launch = ak._launch_smem if route == "smem" else ak._launch_thread
            launch(admm[nz, nc], "boxqp_solve", args, (B, Kst, nz, nc), scal, 0)
        assert ak.LAUNCHES == {"boxqp_solve": 4, "admm_round": 0}
        assert ak.LAUNCHES_BY_SHAPE == {("boxqp_solve", 5, 2): 1, ("boxqp_solve", 5, 3): 2,
                                        ("boxqp_solve", 4, 2): 1}
    finally:
        ak.reset_launch_counts()
    assert ak.LAUNCHES_BY_SHAPE == {}


@pytest.mark.parametrize("system, shape", [("parallel_integrators", (5, 2)),
                                           ("free_space_rocket", (5, 3))])
def test_zoo_first_iteration_qps_through_the_nz5_builds(libs, system, shape):
    """The master zoo's (5, 2) / (5, 3) systems: their config (the zoo
    golden's) through the loader, the QPs of one SQP iteration at 256
    initial states around the config's x0 as the fused backend hands them,
    through the host build: x, y_d, y_b as close to the float64 plain version
    as the float32 plain version (2x + 1e-4, the card's gate); rounds held to
    the float64 plain version's (largest per-lane distance no more than the
    float32 plain version's + 1, mean no more than twice its + 0.05): the
    zoo's qp_tol 1e-7 sits at float32's floor."""
    import json
    import pathlib

    from control_box_rst_tpu_torch.core import config as tc
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    gold = np.load(pathlib.Path(__file__).resolve().parent / "golden" / "torch_master_zoo.npz")
    cfg = json.loads(str(gold[f"{system}/config"]))
    ctrl, _ = tc.build_controller(cfg, dtype=torch.float32, device="cpu")
    x0 = np.asarray(cfg["x0"], dtype=np.float32)
    x0s = x0 + np.random.default_rng(1).uniform(-0.25, 0.25, (256, x0.size)).astype(np.float32)
    x0s[0] = x0
    caught, real = [], ak.boxqp_solve

    def catch(*args, **kw):
        caught.append((args, kw))
        return real(*args, **kw)

    qp = ctrl.cfg.qp.replace(backend="fused")
    try:
        ak.boxqp_solve = catch
        make_batched_solver(ctrl.ocp, ctrl.cfg.replace(max_iter=1, qp=qp), dt_init=0.1,
                            device="cpu")(torch.as_tensor(x0s))
    finally:
        ak.boxqp_solve = real
    assert len(caught) == 1
    args, kw = caught[0]
    dims = ak._check_args(args)
    assert dims[2:] == shape
    keys = ("n_rounds", "iters", "tol", "sigma", "alpha", "rho_eq_scale", "rho_min",
            "rho_max", "tol_stat", "tol_feas")
    out_k = ak._launch_smem(libs[0][shape], "boxqp_solve", args, dims,
                            tuple(kw[k] for k in keys), 0)
    out_p = ak.boxqp_solve_plain(*args, **kw)
    out_d = ak.boxqp_solve_plain(*[a.double() for a in args], **kw)
    for i in (0, 2, 3):
        e_k = float((out_k[i].double() - out_d[i]).abs().max())
        e_p = float((out_p[i].double() - out_d[i]).abs().max())
        assert e_k <= 2.0 * e_p + 1e-4
    k_d = (out_k[6] - out_d[6]).abs() / kw["iters"]
    p_d = (out_p[6] - out_d[6]).abs() / kw["iters"]
    assert float(k_d.max()) <= float(p_d.max()) + 1
    assert float(k_d.mean()) <= 2 * float(p_d.mean()) + 0.05


def test_move_blocking_one_shot_through_the_nc3_build(libs, monkeypatch):
    """Move blocking on config 1 (N = 20, ten blocks of 2): the one-shot
    launches the (4, 3) build once on one shared copy of Hd/J/K (the tie
    rows among the hoisted J/K), and the blocked controls come out as the
    plain version's (1e-4) and equal inside every block (1e-6)."""
    from control_box_rst_tpu_torch import entry
    from control_box_rst_tpu_torch.parallel import make_batched_solver

    ocp, cfg = entry.move_blocking(N=20, device="cpu")
    cfg = cfg.replace(qp=cfg.qp.replace(backend="fused"))
    x0s = np.random.default_rng(0).uniform(-1.0, 1.0, (24, 2)).astype(np.float32)
    U_plain = make_batched_solver(ocp, cfg, device="cpu")(x0s)[0]
    admm = libs[0][4, 3]
    calls = []

    def launch(*args, **kw):
        dims = ak._check_args(args)
        calls.append((dims, ak._lane_invariant(*args[:3])))
        keys = ("n_rounds", "iters", "tol", "sigma", "alpha", "rho_eq_scale", "rho_min",
                "rho_max", "tol_stat", "tol_feas")
        return ak._launch_smem(admm, "boxqp_solve", args, dims, tuple(kw[k] for k in keys), 0)

    monkeypatch.setattr(ak, "boxqp_solve", launch)
    U, _, status, iters = make_batched_solver(ocp, cfg, device="cpu")(x0s)
    assert calls[0] == ((24, 21, 4, 3), True)  # the one-shot, Hd/J/K shared
    assert len(calls) == int(iters.max()) and bool((status == 1).all())
    np.testing.assert_allclose(U.numpy(), U_plain.numpy(), rtol=0, atol=1e-4)
    Ub = U[..., 0].reshape(24, 10, 2)
    assert float((Ub - Ub[..., :1]).abs().max()) <= 1e-6


@pytest.mark.parametrize("case", [(1, 5), (3, 6), (40, 4), (9, 9)],
                         ids=lambda c: "B{}_Kst{}".format(*c))
def test_admm_round_kernels_on_the_host(libs, case):
    admm = libs[0][NZ, NC]
    B, Kst = case
    args, dims = _qps(B, Kst, shared=B % 2 == 1, seed=B), (B, Kst, NZ, NC)
    scal = (3, *BASE)
    smem = ak._launch_smem(admm, "admm_round", args, dims, scal, 0)
    thread = ak._launch_thread(admm, "admm_round", args, dims, scal, 0)
    plain = ak.admm_round_plain(*args, *scal)
    for a, b in zip(smem, thread):
        assert torch.equal(a, b)
    np.testing.assert_allclose(smem[0].numpy(), plain[0].numpy(), rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(smem[4].numpy(), plain[4].numpy(), rtol=1e-2, atol=1e-4)


def test_quotient_from_the_reciprocal_is_the_division_on_the_host(libs):
    """The kernels' quotient against the division, bit for bit (the card runs
    the same check on 16 M pairs): mantissas and exponents from a seed, zeros,
    infinities, NaNs and subnormals mixed in."""
    admm = libs[0][NZ, NC]
    rng = np.random.default_rng(1)
    n = 200_000
    def operands():
        return (rng.choice([-1.0, 1.0], n) * (1 + rng.random(n)) *
                np.exp2(rng.integers(-100, 101, n))).astype(np.float32)
    a, b = operands(), np.abs(operands())
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-42, -1e-42, 3.0], np.float32)
    a[: special.size] = special
    b[-special.size:] = special
    a[-special.size:] = special[::-1]
    a, b = torch.from_numpy(a), torch.from_numpy(b)
    out = torch.empty(n, dtype=torch.int32)
    err = admm.admm_division_check_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, 0)
    assert err == 0 and int(out.sum()) == 0


def _spd(B, K, nz, seed=3):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, K, nz, nz)).astype(np.float32)
    D = D @ D.transpose(0, 1, 3, 2) + 10 * np.eye(nz, dtype=np.float32)
    O = (0.3 * rng.standard_normal((B, K - 1, nz, nz))).astype(np.float32)
    b = rng.standard_normal((B, K, nz)).astype(np.float32)
    return [torch.from_numpy(a) for a in (D, O, b)]


@pytest.mark.parametrize("nz", [4, 3, 2])
@pytest.mark.parametrize("shape", [(1, 1), (1, 5), (11, 7), (19, 2), (8, 13), (17, 25)],
                         ids=lambda s: "B{}_K{}".format(*s))
def test_btridiag_kernels_on_the_host(libs, shape, nz):
    """The shared-memory kernel (nz threads per lane) against the
    one-thread-per-lane kernel of the in-place solve, K3's kernel and the
    plain version; ragged last warps, a single stage, 32 % nz != 0."""
    _, bts = libs
    B, K = shape
    D, O, b = _spd(B, K, nz)
    dims = (B, K, nz)
    x_smem = bk._launch_smem(bts[nz], D, O, b, dims, 0)
    x_two = bk._launch_thread(bts[nz], D, O, b, dims, 0)
    x_k3 = bk._launch_scratch(bts[nz], D, O, b, dims, 0)
    assert torch.equal(x_smem, x_two) and torch.equal(x_two, x_k3)
    info = bk.LAUNCH_INFO["btridiag_factor_solve"]
    assert info["route"] == "scratch" and info["threads_per_lane"] == 1
    np.testing.assert_allclose(
        x_smem.numpy(), bk.btridiag_factor_solve_plain(D, O, b).numpy(), rtol=0, atol=5e-6)


@pytest.mark.parametrize("case", ["broadcast", "strided-lanes", "transposed-b", "not-spd",
                                  "misaligned"])
@pytest.mark.parametrize("kernel", ["smem", "scratch"])
def test_btridiag_shared_memory_kernel_takes_operands_as_they_are(libs, kernel, case):
    """Both kernels that read the caller's batch-first tensors as they are:
    K4's shared-memory kernel and K3's scratch kernel."""
    _, bts = libs
    nz = 4
    D, O, b = _spd(9, 6, nz, seed=5)
    if case == "broadcast":
        D, O = D[0].expand(D.shape), O[0].expand(O.shape)
    elif case == "strided-lanes":
        D, O, b = D[::2], O[::2], b[::2]
    elif case == "transposed-b":
        b = b.transpose(0, 1).contiguous().transpose(0, 1)
    elif case == "misaligned":
        D, O, b = (misaligned(a) for a in (D, O, b))
    else:
        D = D.clone()
        D[2, 3] = -torch.eye(nz)
    before = [a.clone() for a in (D, O, b)]
    launch = bk._launch_smem if kernel == "smem" else bk._launch_scratch
    x = launch(bts[nz], D, O, b, (D.shape[0], 6, nz), 0)
    assert all(torch.equal(a, c) for a, c in zip((D, O, b), before))  # inputs are read only
    want = bk.btridiag_factor_solve_plain(D, O, b)
    if case == "not-spd":
        # a negative pivot gives NaN in its lane, and in no other
        assert bool(torch.isnan(x[2]).any()) and bool(torch.isnan(want[2]).any())
        keep = [0, 1, 3, 4, 5, 6, 7, 8]
        x, want = x[keep], want[keep]
    np.testing.assert_allclose(x.numpy(), want.numpy(), rtol=0, atol=5e-6)


def _through_the_host_kernel(monkeypatch, bts):
    """Route the solvers' block-tridiagonal calls to the host builds of K4's
    shared-memory kernel and, for ``inplace=False``, K3's scratch kernel (the
    wrapper's own launch code, counting as on the card)."""
    from control_box_rst_tpu_torch.solvers import ip as ip_mod
    from control_box_rst_tpu_torch.solvers import lm as lm_mod

    def launch(D, O, b, inplace=True):
        assert D.dtype == torch.float32
        kernel = bk._launch_smem if inplace else bk._launch_scratch
        return kernel(bts[D.shape[-1]], D, O, b, bk._check_args(D, O, b), 0)

    monkeypatch.setattr(ip_mod, "btridiag_factor_solve", launch)
    monkeypatch.setattr(lm_mod, "btridiag_factor_solve", launch)


def test_ip_and_lm_paths_through_the_host_kernels(libs, monkeypatch):
    """Launches by path, as ``chip_smoke.py`` counts them on the card: one
    K4 launch per lock-step iteration on every path (nz = 2 for the IP
    Schur systems, 16 lanes a warp; nz = 4 for LM), one K3 launch per
    lock-step iteration where the IP solver is asked for ``inplace=False``,
    and the answers as close to the plain version's as two float32 solves
    are."""
    from control_box_rst_tpu_torch import entry
    from control_box_rst_tpu_torch.parallel import (
        make_batched_closed_loop,
        make_batched_ip_solver,
        make_batched_lm_solver,
    )

    _, bts = libs
    x0s1 = np.random.default_rng(0).uniform(-1.0, 1.0, (19, 2)).astype(np.float32)
    d = np.random.default_rng(6).uniform(-2.0, 2.0, 9)
    d[0] = 2.0
    x0s_di = np.stack([d, np.zeros_like(d)], axis=1).astype(np.float32)
    ocp1, cfg1 = entry.flagship_ip(N=12, device="cpu")
    di, _, lm_cfg, ip_cfg = entry.constrained_di(device="cpu")
    paths = {
        "config1_ip": lambda: make_batched_ip_solver(ocp1, cfg1, device="cpu")(x0s1),
        "constrained_di_ip": lambda: make_batched_ip_solver(
            di, ip_cfg, dt_init=0.25, device="cpu")(x0s_di),
        "constrained_di_ip_inplace_false": lambda: make_batched_ip_solver(
            di, ip_cfg, dt_init=0.25, device="cpu", inplace=False)(x0s_di),
        "constrained_di_lm": lambda: make_batched_lm_solver(
            di, lm_cfg.replace(max_iter=40), dt_init=0.25, device="cpu")(x0s_di[:3]),
    }
    plain = {name: fn() for name, fn in paths.items()}
    _through_the_host_kernel(monkeypatch, bts)
    launches_by_path = {}
    for name, fn in paths.items():
        bk.reset_launch_counts()
        out = fn()
        k3 = name.endswith("inplace_false")
        kernel, other = "btridiag_factor_solve", "btridiag_factor_solve_inplace"
        if not k3:
            kernel, other = other, kernel
        launches_by_path[name] = bk.LAUNCHES[kernel]
        assert bk.LAUNCHES[other] == 0
        iters = out[3]
        assert launches_by_path[name] == int(iters.max()) > 0, name
        info = bk.LAUNCH_INFO[kernel]
        nz = 4 if name.endswith("lm") else 2
        K = (12 if name == "config1_ip" else 25) + (0 if nz == 2 else 1)
        if k3:
            assert info["route"] == "scratch" and info["threads_per_lane"] == 1, info
        else:
            assert info["route"] == "smem" and info["lanes_per_warp"] == 32 // nz, info
            assert info["smem_bytes_per_lane"] == bk.factor_bytes_per_lane(K, nz)
        np.testing.assert_allclose(out[0].numpy(), plain[name][0].numpy(), rtol=0, atol=2e-3)
        np.testing.assert_array_equal(out[2].numpy(), plain[name][2].numpy())
    # the IP controller of config 5 (N=12 here), 3 steps
    ctrl, plant, _, dt = entry.rollouts_ip(N=12, device="cpu")
    bk.reset_launch_counts()
    res = make_batched_closed_loop(ctrl, plant, 3, dt, device="cpu")(x0s1[:5])
    launches_by_path["ip_controller"] = bk.LAUNCHES["btridiag_factor_solve_inplace"]
    lock_step = res.info["sqp_iters"].amax(dim=0)
    assert launches_by_path["ip_controller"] == int(lock_step.sum()) > 0
    assert bool(torch.isfinite(res.u).all()) and float(res.u.abs().max()) <= 1.0 + 1e-6
    assert min(launches_by_path.values()) > 0

