#!/usr/bin/env python3
"""Where a lane's time goes inside the shared-memory box-QP kernels.

    python3 tools/chip_probes/phase_clocks.py        # needs an NVIDIA GPU and nvcc

The profilers that read stall reasons are not always to be had; a kernel can
still time itself. This probe makes a copy of
``control_box_rst_tpu_torch/csrc/admm_kernel.cu`` in which the round function
of the shared-memory route (``smem_round``) reads ``clock64()`` at its phase
boundaries and the first thread of block 0 sums the differences into a
``__device__`` array, builds it, runs one rho-round of 12 iterations on the
config-1 QPs (Kst=51, nz=4, nc=2) for one lane and for 32768 lanes, with 1, 2
and 4 lanes per warp (the team size is a compile-time constant of the source:
the probe builds its copy three times, with ``-DTEAM=32``, ``16`` and ``8``),
and prints per phase the cycles that thread saw: per-row
rho, factorization, and per ADMM iteration the right-hand side, the two
substitutions (the chain) and the updates; then the residuals. The copy is
made by inserting lines before marker comments of the source; the probe fails
if a marker is gone.
"""
import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from control_box_rst_tpu_torch.entry import flagship  # noqa: E402
from control_box_rst_tpu_torch.ops.cuda import admm_kernel as ak  # noqa: E402
from control_box_rst_tpu_torch.ops.cuda import build  # noqa: E402

PHASES = ("per-row rho", "factorization", "right-hand side", "chain", "updates", "residuals")


def instrumented_source() -> str:
    src = ak.SOURCE.read_text()
    a = src.index("__device__ void smem_round(")
    b = src.index("// Slot of the thread's team in the block's shared memory")
    body = src[a:b]

    def before(marker, code):
        nonlocal body
        if body.count(marker) != 1:
            raise RuntimeError(f"marker not found exactly once in smem_round: {marker!r}")
        body = body.replace(marker, code + "\n" + marker)

    before("    // ---- per-row rho: the pin test",
           "    const bool rec = threadIdx.x == 0 && blockIdx.x == 0; long long T0 = clock64();")
    before("    // ---- assemble + factor M = L L'", "    long long T1 = clock64();")
    before("    // ---- ADMM iterations ----",
           "    long long T2 = clock64(); if (rec) { g_clk[0] += T1 - T0; g_clk[1] += T2 - T1; }")
    before("        // right-hand side, every term but", "        long long Ta = clock64();")
    before("        // the two substitutions, in place", "        long long Tb = clock64();")
    before("        // updates: y_d by interval row", "        long long Tc = clock64();")
    before("    // ---- residuals, once, on the final iterate", "    long long T3 = clock64();")
    end_of_iteration = "        __syncwarp();\n    }\n\n    long long T3"
    if body.count(end_of_iteration) != 1:
        raise RuntimeError("end of the iteration loop not found in smem_round")
    body = body.replace(
        end_of_iteration,
        "        __syncwarp();\n        long long Td = clock64(); if (rec) { g_clk[2] += Tb - Ta; "
        "g_clk[3] += Tc - Tb; g_clk[4] += Td - Tc; g_clk[6] += 1; }\n    }\n\n    long long T3")
    before("    pr_out = team_max(pr);", "    if (rec) g_clk[5] += clock64() - T3;")
    return src[:a] + "__device__ long long g_clk[8];\n" + body + src[b:] + '''
extern "C" int admm_read_clocks(long long* host) {
    cudaError_t e = cudaMemcpyFromSymbol(host, g_clk, sizeof(long long) * 8);
    long long zero[8] = {};
    cudaMemcpyToSymbol(g_clk, zero, sizeof zero);
    return (int)e;
}
'''


def main() -> int:
    if not torch.cuda.is_available():
        print("phase_clocks: no CUDA device present", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    ocp, cfg = flagship(N=50)
    out_dir = build.build_dir() / "probes"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "admm_phase_clocks.cu"
    src.write_text(instrumented_source())
    libs, builds = {}, []
    for per_warp in (1, 2, 4):  # one nvcc per team size, all started together
        lib_path = out_dir / f"libadmm_phase_clocks_{per_warp}.so"
        cmd = [build.find_nvcc(), *build.NVCC_FLAGS, f"-I{build.CSRC}", f"-DNZ={ocp.nz}",
               f"-DNC={ocp.nc}", f"-DTEAM={32 // per_warp}", "-o", str(lib_path), str(src)]
        builds.append((per_warp, lib_path, subprocess.Popen(cmd)))
    for per_warp, lib_path, proc in builds:
        if proc.wait() != 0:
            raise RuntimeError(f"nvcc failed for {lib_path}")
        libs[per_warp] = ctypes.CDLL(str(lib_path))
        ak.declare(libs[per_warp], ocp.nz, ocp.nc)
        libs[per_warp].admm_read_clocks.argtypes = [ctypes.c_void_p]

    def clocks(lib):
        torch.cuda.synchronize()
        host = (ctypes.c_longlong * 8)()
        lib.admm_read_clocks(host)
        return list(host)

    qp = cfg.qp
    scal = (qp.iters_per_round, qp.sigma, qp.alpha, qp.rho_eq_scale)
    x0s = torch.as_tensor(
        np.random.default_rng(0).uniform(-1.0, 1.0, size=(cs.BATCH, 2)).astype(np.float32),
        device="cuda")
    args = cs.config1_qps(ocp.to(device="cuda", dtype=torch.float32), x0s)
    stream = torch.cuda.current_stream().cuda_stream
    for B in (1, cs.BATCH):
        lanes = [a[:B] for a in args]
        dims = (B, ocp.N + 1, ocp.nz, ocp.nc)
        for per_warp, lib in libs.items():
            run = lambda: ak._launch_smem(lib, "admm_round", lanes, dims, scal, stream)
            clocks(lib)
            run()
            c = clocks(lib)
            ms = cs.time_ms(run, 3)
            clocks(lib)
            n = max(c[6], 1)
            cycles = [c[0], c[1], c[2] / n, c[3] / n, c[4] / n, c[5]]
            print(f"B={B} lanes_per_warp={per_warp} one round of {n} iterations {ms:.3f} ms | "
                  + ", ".join(f"{name} {v:.0f}" for name, v in zip(PHASES, cycles))
                  + " cycles (right-hand side, chain, updates: per iteration)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
