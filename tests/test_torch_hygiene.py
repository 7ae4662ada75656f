"""Hygiene of the PyTorch port: it stands alone.

No module under control_box_rst_tpu_torch/ nor chip_smoke.py imports ``jax``
or anything of ``control_box_rst_tpu``; the package imports on a CPU-only
machine without building or looking for anything; its entry points refuse to
run on the CPU unless asked to.
"""
import ast
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "control_box_rst_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
CUDA_SOURCES = sorted((PKG / "csrc").glob("*.cu"))
CUDA_HEADERS = sorted(p.name for p in (PKG / "csrc").glob("*.cuh"))
FORBIDDEN = ("jax", "jaxlib", "control_box_rst_tpu", "triton")


def _imported_roots(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_module_imports_no_jax(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path}: forbidden imports {bad}"


@pytest.mark.parametrize("path", CUDA_SOURCES, ids=lambda p: p.name)
def test_cuda_source_has_a_plain_c_interface(path):
    """A kernel source is bound with ctypes: it includes the CUDA runtime's
    headers only (no PyTorch, no library of finished kernels), exports
    ``extern "C"`` entry points that return ``cudaGetLastError()``, targets
    no fast-math, and says which TPU kernel it replaces."""
    import re

    text = path.read_text()
    includes = re.findall(r'#include\s*[<"]([^>"]+)[>"]', text)
    assert includes and set(includes) <= {"cuda_runtime.h", "math_constants.h", *CUDA_HEADERS}, includes
    assert 'extern "C"' in text and "cudaGetLastError()" in text
    assert "control_box_rst_tpu/ops/pallas/" in text
    assert "<<<" in text and "__global__" in text
    wrapper = PKG / "ops" / "cuda" / (path.stem + ".py")
    assert wrapper.is_file() and f'"{path.name}"' in wrapper.read_text()


def test_every_listed_module_exists():
    assert [p.name for p in CUDA_SOURCES] == ["admm_kernel.cu", "btridiag_kernel.cu"]
    assert CUDA_HEADERS == ["quotient.cuh"]
    # a header of csrc/ holds device helpers only: no include, no kernel, no launch
    header = (PKG / "csrc" / "quotient.cuh").read_text()
    assert not any(s in header for s in ("#include", "__global__", "<<<", "torch"))
    for rel in (
        "utils/tree.py", "utils/precision.py", "core/types.py", "ops/smallmat.py",
        "ops/btridiag.py", "ops/collocation.py", "ops/cuda/admm_kernel.py",
        "ops/cuda/btridiag_kernel.py", "ops/cuda/build.py", "ops/cuda/layout.py",
        "csrc/admm_kernel.cu", "csrc/btridiag_kernel.cu", "csrc/quotient.cuh",
        "models/base.py", "models/benchmark.py",
        "ocp/problem.py", "ocp/grids.py", "ocp/costs.py", "ocp/transcribe.py",
        "ocp/constraints.py", "ocp/preprocessor.py",
        "solvers/stage_qp.py", "solvers/sqp.py", "solvers/lm.py", "solvers/ip.py",
        "solvers/simple_nlp.py",
        "ops/btridiag_cr.py", "ops/matrix_eq.py", "control/classic.py",
        "control/dual_mode.py", "sim/observer.py",
        "parallel/sharded_solve.py", "parallel/mesh.py", "entry.py", "convert.py",
        "core/factory.py", "core/signals.py", "core/export.py", "core/time_series.py",
        "core/reference.py", "core/config.py", "sim/environment.py", "master.py",
        "models/outputs.py", "models/filters.py", "ops/integrators.py",
        "core/console.py", "core/timex.py", "native/__init__.py", "native/runtime.cpp",
        "utils/profiling.py", "comm/__init__.py", "comm/service.py", "comm/server.py",
        "comm/client.py", "comm/master_service_pb2.py", "comm/proto/master_service.proto",
        "sim/plant_threaded.py", "sim/realtime.py", "gui/__init__.py", "gui/__main__.py",
        "gui/app.py", "gui/scope.py", "gui/signal_helper.py",
    ):
        assert (PKG / rel).is_file(), rel


@pytest.mark.parametrize("rel", ["comm/master_service_pb2.py", "comm/proto/master_service.proto",
                                 "native/runtime.cpp"])
def test_copies_of_the_reference_are_byte_for_byte(rel):
    """The generated protobuf module and its IDL are the JAX package's, byte
    for byte (the same wire; one descriptor pool when both packages meet in
    one process), and so is the native runtime's source."""
    assert (PKG / rel).read_bytes() == (ROOT / "control_box_rst_tpu" / rel).read_bytes()


def test_package_import_leaves_the_service_and_the_runtime_alone():
    """``import control_box_rst_tpu_torch`` imports neither ``comm`` nor
    ``grpc`` (the port imports where grpc is absent), and importing every
    module loads no native library (``native`` builds at first use)."""
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in SOURCES[:-1] if p.name != "__init__.py"
    ]
    code = (
        "import importlib, sys\n"
        "import control_box_rst_tpu_torch\n"
        "assert 'grpc' not in sys.modules, 'grpc'\n"
        "assert not any(m.startswith('control_box_rst_tpu_torch.comm') for m in sys.modules)\n"
        f"[importlib.import_module(m) for m in {mods!r}]\n"
        "from control_box_rst_tpu_torch import native\n"
        "assert native._lib is None\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_package_imports_in_a_fresh_process_without_jax():
    """Import every module of the package in a clean interpreter and check
    that neither jax nor the JAX package came along, and that TF32 is off."""
    mods = [
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        for p in SOURCES[:-1] if p.name != "__init__.py"
    ]
    code = (
        "import importlib, sys\n"
        f"[importlib.import_module(m) for m in {mods!r}]\n"
        "import torch\n"
        "assert 'jax' not in sys.modules and 'control_box_rst_tpu' not in sys.modules\n"
        "assert not torch.backends.cuda.matmul.allow_tf32\n"
        "assert not torch.backends.cudnn.allow_tf32\n"
        "print('ok')\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_service_and_realtime_refuse_the_cpu_unless_asked():
    """The gRPC master, the threaded plant and the real-time loop take
    ``device=None`` to mean the card too."""
    from control_box_rst_tpu_torch.comm import MasterServer
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.sim import SimulatedPlant, SimulatedPlantThreaded
    from control_box_rst_tpu_torch.sim.realtime import run_realtime_closed_loop

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is allowed to run")
    plant = SimulatedPlant(system=DoubleIntegratorContinuous())
    x0 = np.zeros(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MasterServer()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SimulatedPlantThreaded(plant, x0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_realtime_closed_loop(None, lambda: x0, lambda u: None, x0, 0.1, 0.1)
    assert MasterServer(device="cpu").device.type == "cpu"
    assert SimulatedPlantThreaded(plant, x0, device="cpu")._device.type == "cpu"


def test_entry_points_refuse_the_cpu_unless_asked():
    from control_box_rst_tpu_torch.entry import entry, flagship, flagship_lm
    from control_box_rst_tpu_torch.parallel import make_batched_lm_solver, make_batched_solver
    from control_box_rst_tpu_torch.utils.precision import resolve_device, resolve_dtype

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is allowed to run")
    ocp, cfg = flagship(N=4, device="cpu")
    with pytest.raises(RuntimeError):
        make_batched_solver(ocp, cfg, device=None)
    with pytest.raises(RuntimeError):
        flagship_lm(N=4)
    with pytest.raises(RuntimeError):
        make_batched_lm_solver(*flagship_lm(N=4, device="cpu"), device=None)
    with pytest.raises(RuntimeError):
        entry()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu").type == "cpu"
    with pytest.raises(ValueError):
        resolve_dtype(torch.float16)
    _assert_the_mesh_refuses_the_cpu_unless_asked()


def _assert_the_mesh_refuses_the_cpu_unless_asked():
    """``make_mesh()`` without a card raises; ``make_mesh(device_type="cpu")``
    builds the one-rank mesh (its process group is taken down again)."""
    import torch.distributed as dist

    from control_box_rst_tpu_torch.parallel import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    assert not dist.is_initialized()
    try:
        mesh = make_mesh(device_type="cpu")
        assert mesh.size() == 1 and mesh.device_type == "cpu"
        assert mesh.mesh_dim_names == ("batch",)
    finally:
        dist.destroy_process_group()


# a one-step closed loop of the config loader (the CPU run takes ~1 s)
_LOADER_CONFIG = {
    "experiment": {"task": "closed_loop", "T_steps": 1, "dt": 0.1},
    "system": {"type": "serial_integrators", "params": {"nx": 2, "nu": 1}},
    "grid": {"type": "fd", "N": 4}, "bounds": {"u_min": -1.0, "u_max": 1.0},
    "x0": [1.0, 0.0], "solver": {"max_iter": 2},
}


def test_constructors_refuse_the_cpu_unless_asked():
    """``flagship``, ``transcribe``, ``Bounds.unbounded``, every ``convert``
    function, ``zero_warm_start`` and the config loader's builders and
    ``run_experiment`` create tensors, so ``device=None`` means the card for
    them too."""
    from control_box_rst_tpu_torch import convert
    from control_box_rst_tpu_torch.core import config
    from control_box_rst_tpu_torch.entry import flagship
    from control_box_rst_tpu_torch.models import DoubleIntegratorContinuous
    from control_box_rst_tpu_torch.ocp import (
        Bounds,
        QuadraticFormCost,
        finite_differences_grid,
        transcribe,
    )
    from control_box_rst_tpu_torch.solvers.stage_qp import zero_warm_start

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is allowed to run")
    z = np.zeros((3, 2))
    calls = [
        lambda **kw: flagship(N=4, **kw),
        lambda **kw: zero_warm_start(4, 4, 2, 0, **kw),
        lambda **kw: Bounds.unbounded(2, 1, **kw),
        lambda **kw: transcribe(
            DoubleIntegratorContinuous(),
            finite_differences_grid(4, fd_scheme="crank_nicolson"),
            QuadraticFormCost(Q=torch.eye(2), R=torch.eye(1)), **kw),
        lambda **kw: convert.trajectory_from_numpy(dict(X=z, U=z, dts=z), **kw),
        lambda **kw: convert.qp_warm_start_from_numpy(
            dict(delta=z, y_dyn=z, y_gen=z, y_box=z), **kw),
        lambda **kw: convert.sqp_warm_start_from_numpy(
            dict(W=z, y_dyn=z, y_gen=z, y_box=z), **kw),
        lambda **kw: convert.system_from_numpy(
            dict(system="linear_state_space", nx=2, nu=1, A=np.eye(2), B=np.ones((2, 1))), **kw),
        lambda **kw: config.build_ocp(_LOADER_CONFIG, **kw),
        lambda **kw: config.build_controller(_LOADER_CONFIG, **kw),
        lambda **kw: config.run_experiment(_LOADER_CONFIG, **kw),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
        call(device="cpu")
    w = zero_warm_start(4, 4, 2, 0, device="cpu", lead=(3,))
    assert w.delta.shape == (3, 5, 4) and w.delta.dtype == torch.float32


def test_status_codes_match_the_reference():
    from control_box_rst_tpu.core import types as ref
    from control_box_rst_tpu_torch.core import types

    for name in ("SolverStatus", "ControllerStatus"):
        got, want = getattr(types, name), getattr(ref, name)
        assert {s.name: int(s) for s in got} == {s.name: int(s) for s in want}, name


def test_entry_runs_on_cpu_when_asked():
    from control_box_rst_tpu_torch.entry import entry

    torch.set_num_threads(1)
    fn, (x0s,) = entry(device="cpu")
    U = fn(x0s[:2])
    assert U.shape == (2, 50, 1) and bool(torch.isfinite(U).all())
    assert float(U.abs().max()) <= 1.0 + 1e-4


def test_a_missing_compiler_raises():
    """No nvcc here: asking for a kernel library raises (and a CUDA tensor
    would therefore raise in the wrappers); nothing falls back."""
    import shutil

    from control_box_rst_tpu_torch.ops.cuda import admm_kernel, btridiag_kernel, build

    if shutil.which("nvcc") or (pathlib.Path("/usr/local/cuda/bin/nvcc")).exists():
        pytest.skip("a CUDA compiler is present")
    for spec in (admm_kernel.build_spec(4, 2), btridiag_kernel.build_spec(4)):
        assert spec[0].is_file()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.build(*spec)
    a, b = build.library_path(*btridiag_kernel.build_spec(4)), build.library_path(
        *btridiag_kernel.build_spec(3))
    assert a != b and a.parent == build.build_dir() and "nz4" in a.name


def test_chip_smoke_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(ROOT / "chip_smoke.py")], cwd=ROOT,
        capture_output=True, text=True,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
