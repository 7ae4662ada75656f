#!/usr/bin/env python3
"""Build and run division_latency.cu on the card (needs nvcc and an NVIDIA GPU).

    python3 tools/chip_probes/division_latency.py

Prints (1) the cycles one thread pays per dependent step for a fused
multiply-add, a float32 division, a division whose numerator is exactly zero
(the hardware's slow path), a square root, and the quotient the kernels of
``control_box_rst_tpu_torch/csrc/`` build from a reciprocal; (2) on 1.1e9
pseudo-random operand pairs per exponent window, how often that quotient (with
two corrections, as the kernels compute it, and with one) differs in a bit
from the division: never inside 2^-60..2^60, the window the kernels guard.
"""
import pathlib
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parents[1]
sys.path.insert(0, str(ROOT))

from control_box_rst_tpu_torch.ops.cuda import build  # noqa: E402


def main() -> int:
    out_dir = build.build_dir() / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    exe = out_dir / "division_latency"
    subprocess.run([build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-o", str(exe), str(HERE / "division_latency.cu")], check=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    return subprocess.run([str(exe)]).returncode


if __name__ == "__main__":
    sys.exit(main())
