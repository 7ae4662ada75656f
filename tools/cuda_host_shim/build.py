#!/usr/bin/env python3
"""Compile a CUDA source of control_box_rst_tpu_torch/csrc/ as host C++.

    python3 tools/cuda_host_shim/build.py SOURCE.cu OUT.so [-DNZ=4 -DNC=2 ...]

Rehearsal for a machine without a GPU or nvcc: the kernel launches of the
source are rewritten into calls of the stand-in runtime beside this file
(cuda_runtime.h, shim.cpp), the result is compiled with g++ into a shared
library with the source's own ``extern "C"`` entry points (headers the source
includes by ``#include "name"`` are taken from its own directory), and the wrappers'
ctypes code can drive it with CPU tensors (``data_ptr()`` of a CPU tensor is a
host pointer; pass 0 for the stream). tests/test_torch_kernel_rehearsal.py does
exactly that. Multiply-adds are not contracted here (-ffp-contract=off, and
fmaf is exact), so two kernels that run the same statements in the same
order give the same bits, which is a sharper check than the card allows.
"""
import pathlib
import re
import subprocess
import sys

HERE = pathlib.Path(__file__).resolve().parent
LAUNCH = re.compile(r"(\w+)<<<([^;]*?)>>>\(")


def host_source(cuda_text: str) -> str:
    """The CUDA text with every ``kernel<<<cfg>>>(`` turned into
    ``SHIM_LAUNCH(cfg, kernel, `` and the runtime's headers taken from here."""
    text = LAUNCH.sub(r"SHIM_LAUNCH(\2, \1, ", cuda_text)
    for header in ("cuda_runtime.h", "math_constants.h"):
        text = text.replace(f"#include <{header}>", f'#include "{header}"')
    return text


def build(source: pathlib.Path, out: pathlib.Path, defines=()) -> pathlib.Path:
    out.parent.mkdir(parents=True, exist_ok=True)
    pre = out.with_suffix(".host.cpp")
    pre.write_text(host_source(source.read_text()))
    cmd = ["g++", "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared", "-pthread",
           "-Wl,-Bsymbolic", f"-I{HERE}", f"-I{source.parent}", *defines, "-o", str(out), str(pre), str(HERE / "shim.cpp")]
    done = subprocess.run(cmd, capture_output=True, text=True)
    if done.returncode != 0:
        raise RuntimeError(f"g++ failed: {' '.join(cmd)}\n{done.stdout}\n{done.stderr}")
    return out


if __name__ == "__main__":
    if len(sys.argv) < 3:
        sys.exit(__doc__)
    print(build(pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2]), sys.argv[3:]))
