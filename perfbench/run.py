#!/usr/bin/env python3
"""Run one cell of the benchmark once, on the card, and print its result.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Load the cell's configuration and traffic (``spec.py``), build the port,
warm up the cell's own shapes, measure for ``--seconds``, check the sampled
answers against the plain reference, and print one JSON line last on
standard output: ``--trace 0`` the cell's end-to-end metrics, ``--trace 1``
its per-layer metrics read from a profiler trace of a few whole units inside
the window. Exits non-zero, with no result, when there is no card, when the
port cannot be imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_IMPORT = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the checkout's root, not this folder, is where imports start
if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)
FORBIDDEN = ("jax", "jaxlib", "flax", "control_box_rst_tpu")


def since_process_start() -> float:
    """Seconds since this process started (the kernel's start time)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - T_IMPORT


def forbidden_modules() -> list:
    """Top-level names of loaded modules that are JAX's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _env() -> None:
    # caches inside the checkout, at fixed paths; nothing loads JAX by itself
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(ROOT / "build" / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(ROOT / "build" / "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_cell(workload: str, seed: int, seconds: float, traced: bool, device: str = "cuda",
             root: pathlib.Path = None, traffic_overrides: dict = None, setup_clock=None):
    """One run of a cell; returns (result dict, compared-numbers table).
    ``device="cpu"``, ``traffic_overrides`` and ``root`` serve the CPU tests
    (a tiny run of the rest of the harness)."""
    import torch

    from perfbench import check, generator, spec, tracing
    from perfbench.record import Record
    from perfbench.system import System

    clock = setup_clock or since_process_start
    phases = [("imports", clock())]
    cell = spec.cell(workload, **({"root": root} if root else {}))
    traffic = dict(cell.traffic, **(traffic_overrides or {}))
    torch.set_num_threads(2)
    if device != "cpu":
        torch.empty(1, device=device)  # the CUDA context
        phases.append(("context", clock()))
    sut = System(cell.config, traffic, device)
    phases.append(("build", clock()))
    generator.warm_up(sut, traffic, seed)
    setup_s = clock()
    phases.append(("warm-up", setup_s))
    w = generator.run_window(sut, traffic, seed, seconds, traced)
    phases.append(("window", clock()))
    q = max(1, len(w.unit_s) // 4)
    quarters = [sorted(w.unit_s[i:i + q])[len(w.unit_s[i:i + q]) // 2]
                for i in range(0, len(w.unit_s), q)]
    print(f"perfbench: {w.units} units, first {[round(t, 6) for t in w.unit_s[:3]]} s, "
          f"median by quarter of the window {[round(t, 6) for t in quarters]} s, "
          f"max {max(w.unit_s):.6f} s", file=sys.stderr)
    on_card = device != "cpu"
    if on_card:
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        kind_name, count = torch.cuda.get_device_name(0), 1
    else:
        peak, kind_name, count = 0, "cpu", 0
    result = dict(correct=False, attempted=w.lanes, failed=w.failed, metrics={},
                  device=dict(platform="gpu" if on_card else "cpu", kind=kind_name,
                              count=count, memory_peak_bytes=int(peak)))
    if traced:
        t = tracing.reduce(w.trace)
        w.trace = None
        rec = Record(kind=traffic["kind"], window_s=t.window_s, busy_s=t.busy_s,
                     n_kernels=t.n_kernels, k1_s=t.k1_s, k1_shapes=w.k1_shapes,
                     traced_units=w.traced_units, traced_steps=w.traced_steps,
                     traced_k1_launches=w.traced_k1_launches, units=w.units,
                     k1_launches=w.k1_launches)
        for m in cell.per_layer:
            value = spec.reader(m["name"], **({"root": root} if root else {}))(rec)
            if value is not None:
                result["metrics"][m["name"]] = dict(value=value, unit=m["unit"])
        result["device"].update(busy_s=t.busy_s, window_s=t.window_s)
        result["breakdown"] = dict(device_ops=t.device_ops, idle_gaps=t.idle_gaps)
    else:
        rate = {"sweep": "solves_per_s", "rollouts": "mpc_steps_per_s"}.get(traffic["kind"])
        values = {"setup_s": setup_s}
        if rate:
            values[rate] = w.lanes / w.seconds
        for m in cell.end_to_end:
            if m["name"] in values:
                result["metrics"][m["name"]] = dict(value=values[m["name"]], unit=m["unit"])
    # the program's state goes before the reference runs on the card
    sample, steps, failed, attempted = w.sample, traffic.get("steps", 0), w.failed, w.lanes
    del sut, w
    if on_card:
        torch.cuda.empty_cache()
    correct, table = check.judge(cell.config, traffic["kind"], sample, steps, cell.limits,
                                 device, failed, attempted)
    phases.append(("trace and check", clock()))
    print("perfbench: seconds since process start at the end of " + ", ".join(
        f"{name} {t:.3f}" for name, t in phases), file=sys.stderr)
    result["correct"] = correct
    result["check"] = table
    return result, table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _env()
    import torch

    from perfbench import spec

    chips = next((w["chips"] for w in spec.load_json(spec.benchmark_path())["workloads"]
                  if w["name"] == args.workload), 1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"perfbench: needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import control_box_rst_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the port cannot be imported: {e}", file=sys.stderr)
        return 4
    result, table = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"perfbench: loaded in this process: {found}", file=sys.stderr)
        return 3
    print(f"perfbench: {result['device']['kind']} / power limit: {power_limit()}",
          file=sys.stderr)
    for name, row in table.items():
        print(f"check {name} {row['value']!r} limit {row['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
