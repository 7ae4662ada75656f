"""A run's import path leaves neither JAX nor the JAX package loaded, with
top-level module names compared whole (the port's name begins with the JAX
package's), and the reference loads nothing of the program."""
import json
import pathlib
import subprocess
import sys

from perfbench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]


def loaded(code: str) -> set:
    prog = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); {code}; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_import_path_loads_no_jax():
    names = loaded(
        "from perfbench import run, check, control, generator, spec, system, tracing; "
        "[spec.reader(m['name']) for m in spec.load_json(spec.benchmark_path())['per_layer']]; "
        "from control_box_rst_tpu_torch import entry; "
        "from control_box_rst_tpu_torch.parallel import make_batched_solver, "
        "make_batched_closed_loop; from control_box_rst_tpu_torch.ops.cuda import admm_kernel")
    assert "control_box_rst_tpu_torch" in names
    assert not names & set(run.FORBIDDEN), names & set(run.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    names = loaded("from perfbench import check; from perfbench.counts import k1, peaks")
    assert not names & {"control_box_rst_tpu_torch", *run.FORBIDDEN}


def test_the_run_time_check_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "control_box_rst_tpu_torch_extra", sys)
    monkeypatch.setitem(sys.modules, "jaxlike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "control_box_rst_tpu.ops", sys)
    assert run.forbidden_modules() == ["control_box_rst_tpu"]
