#!/usr/bin/env python3
"""The comparison's control: the plain reference put in the program's place,
computed one step below the configuration's precision (float32 with TF32
products, where the configuration states float32 with TF32 off), and judged
by the same code as a run (``check.judge``).

    python3 perfbench/control.py --workload <cell> --seeds 1,2,3 --units <n>

For each seed it takes the lanes that a run's check of ``--units`` units
compares (``generator.sample_x0``: the same draws and picks), answers them
by the reference in the lower precision, judges those answers as a run's
(its failed share: the lanes the lower precision did not converge on), and
prints ``correct`` with each compared number beside the cell's limit. The
lanes are independent, so answering the sampled lanes alone gives what the
full batches would give them. Runs on the card;
the benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
if sys.path and pathlib.Path(sys.path[0]).resolve() == ROOT / "perfbench":
    sys.path[0] = str(ROOT)


def readings(workload: str, seeds, units: int, device: str = "cuda") -> list:
    import torch

    from perfbench import check, generator, spec

    cell = spec.cell(workload)
    kind, steps = cell.traffic["kind"], cell.traffic.get("steps", 0)
    out = []
    for seed in seeds:
        x0 = generator.sample_x0(cell.traffic, seed, units)
        low = check.reference(cell.config, kind, x0, steps, device,
                              dtype=torch.float32, tf32=True)
        failed = int((~low.pop("converged")).sum())
        correct, table = check.judge(cell.config, kind, dict(low, x0=x0), steps, cell.limits,
                                     device, failed, int(x0.shape[0]))
        out.append(dict(seed=seed, lanes=int(x0.shape[0]), correct=correct, check=table))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--units", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("control: TF32 exists on the card only", file=sys.stderr)
        return 2
    for row in readings(args.workload, [int(s) for s in args.seeds.split(",")], args.units):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
