#!/usr/bin/env python3
"""K3's kernel in its design variants, side by side on the card.

    python3 tools/chip_probes/k3_variants.py     # needs an NVIDIA GPU and nvcc

``control_box_rst_tpu_torch/csrc/btridiag_kernel.cu`` ships K3's kernel
(``btridiag_factor_solve_scratch_kernel``) with three choices fixed: two
sweeps, one stage of loads in flight, a 128-byte L2 fetch hint. This probe
splices ``k3_variants.cu`` (the same kernel with the three choices as
compile-time knobs: ``K3_SWEEPS`` 2 or 3, ``K3_PREFETCH``, ``K3_L2_FETCH`` 0
for no hint) over the K3 section of a copy of that source under
``build/k3_variants/``, builds the copy once per choice in ``VARIANTS`` and
the shipped source once (one ``nvcc`` each, all started together,
``-Xptxas -v`` printed), and at the config-1 shapes (K=51, nz=4, B=32768,
float32) holds each against the plain version and K4's shared-memory kernel
on random SPD systems, and the shipped kernel bit for bit against the
variant (2, 1, 128). Then it times each by itself (torch.profiler) and
through its wrapper (CUDA events) on those systems and on the damped
Gauss-Newton systems of LM's first and 15th iteration on the config-1 batch,
with K4's two kernels beside them. Prints one JSON line per kernel and the
card's name and power limit.
"""
import ctypes
import json
import pathlib
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from control_box_rst_tpu_torch.entry import flagship_lm  # noqa: E402
from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk  # noqa: E402
from control_box_rst_tpu_torch.ops.cuda import build  # noqa: E402

REPS = 5
# (K3_SWEEPS, K3_PREFETCH, K3_L2_FETCH)
SHIPPED = (2, 1, 128)
VARIANTS = ([(s, p, 0) for s in (2, 3) for p in (1, 2, 3)]
            + [SHIPPED, (2, 1, 256), (2, 2, 128), (3, 2, 256)])
K3_TAG = "btridiag_factor_solve_scratch_kernel"
BANNER = "// " + "=" * 75 + "\n// K3: one thread per lane"


def variant_source() -> pathlib.Path:
    """A copy of the shipped source with its K3 section replaced by
    ``k3_variants.cu``, beside copies of the headers it includes."""
    text = bk.SOURCE.read_text()
    cut = text.index(BANNER)
    out = ROOT / "build" / "k3_variants"
    out.mkdir(parents=True, exist_ok=True)
    for header in build.local_headers(bk.SOURCE):
        (out / header.name).write_text(header.read_text())
    src = out / "btridiag_kernel_k3_variants.cu"
    src.write_text(text[:cut] + (pathlib.Path(__file__).parent / "k3_variants.cu").read_text())
    return src


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_variants: no CUDA device present", file=sys.stderr)
        return 1
    print(cs.nvidia_smi_line(), flush=True)
    nz, K, B = 4, 51, cs.BATCH
    src = variant_source()
    specs = [(src, {"NZ": nz, "K3_SWEEPS": s, "K3_PREFETCH": p, "K3_L2_FETCH": f})
             for s, p, f in VARIANTS]
    paths = build.build_all(specs + [bk.build_spec(nz)], verbose=True)
    libs = {}
    for v, path in zip(VARIANTS + ["shipped"], paths):
        libs[v] = ctypes.CDLL(str(path))
        bk.declare(libs[v], nz)

    ocp, lm_cfg = flagship_lm(N=50)
    ocp = ocp.to(device="cuda", dtype=torch.float32)
    rng = np.random.default_rng(0)
    x0s = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(B, 2)).astype(np.float32), device="cuda")
    systems = {"random": cs.random_spd_systems(B, K, nz, "cuda")}
    for it, sys_ in cs.lm_systems(ocp, lm_cfg, x0s, (0, cs.LM_LATE_ITERATION)).items():
        systems[f"lm_it{it}"] = sys_
    D, O, b = systems["random"]
    x_plain = bk.btridiag_factor_solve_plain(D, O, b)
    x_k4 = bk.btridiag_factor_solve(D, O, b)
    torch.cuda.synchronize()

    stream = lambda: torch.cuda.current_stream().cuda_stream
    k4 = {"k4_smem": (lambda D, O, b: bk.btridiag_factor_solve(D, O, b),
                      "btridiag_factor_solve_smem_kernel"),
          "k4_thread": (lambda D, O, b: bk.btridiag_factor_solve(D, O, b, route="thread"),
                        "btridiag_factor_solve_inplace_kernel")}
    rows = []
    for label, (fn, tag) in k4.items():
        row = dict(kernel=label)
        for sname, (Ds, Os, bs) in systems.items():
            row[f"{sname}_ms"] = cs.time_ms(lambda: fn(Ds, Os, bs), REPS)
            row[f"{sname}_alone_ms"] = cs.kernels_alone_ms(
                {label: (lambda: fn(Ds, Os, bs), tag)}, REPS)[label]
        rows.append(row)
        print(json.dumps(row), flush=True)
    x_k3 = {}
    for v in VARIANTS + ["shipped"]:
        lib = libs[v]
        fn = lambda D, O, b, lib=lib: bk._launch_scratch(lib, D, O, b, (D.shape[0], K, nz), stream())
        x_k3[v] = fn(D, O, b)
        torch.cuda.synchronize()
        info = bk.LAUNCH_INFO["btridiag_factor_solve"]
        choices = dict(zip(("sweeps", "prefetch", "l2_fetch_bytes"), SHIPPED if v == "shipped" else v))
        row = dict(kernel="k3_shipped" if v == "shipped" else "k3_variant", **choices,
                   registers_per_thread=info["registers_per_thread"],
                   blocks_per_sm=info["blocks_per_sm"],
                   max_abs_err_vs_plain=float((x_k3[v] - x_plain).abs().max()),
                   max_abs_dx_vs_k4=float((x_k3[v] - x_k4).abs().max()),
                   bit_equal_k4=torch.equal(x_k3[v], x_k4))
        if not row["max_abs_err_vs_plain"] <= 5e-6 or not row["max_abs_dx_vs_k4"] <= 1e-6:
            raise AssertionError(f"K3 {v} disagrees: {row}")
        if v == "shipped" and not torch.equal(x_k3[v], x_k3[SHIPPED]):
            raise AssertionError(f"the shipped K3 kernel is not the variant {SHIPPED} bit for bit")
        for sname, (Ds, Os, bs) in systems.items():
            row[f"{sname}_ms"] = cs.time_ms(lambda: fn(Ds, Os, bs), REPS)
            row[f"{sname}_alone_ms"] = cs.kernels_alone_ms(
                {"k3": (lambda: fn(Ds, Os, bs), K3_TAG)}, REPS)["k3"]
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(cs.nvidia_smi_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
