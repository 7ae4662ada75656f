"""The frozen copy of K1's counts equals the port's functions today, at the
cells' K1 shapes, and the peaks equal the ones the bring-up check uses."""
import pathlib
import re

import pytest

from control_box_rst_tpu_torch.ops.cuda import admm_kernel
from perfbench.counts import k1, peaks

# (Kst, nz, nc, iters, use_kkt, shared_hjk, B) of each cell's K1 launches:
# config 1's one-shot on one hoisted Hd/J/K (the sweep at 32768 lanes, the
# rollouts at 4096) and config 2's per-lane QPs
SHAPES = [
    (51, 4, 2, 12, True, True, 32768),
    (51, 4, 2, 12, True, True, 4096),
    (51, 4, 2, 12, False, True, 4096),
    (21, 4, 2, 30, False, False, 4096),
]


@pytest.mark.parametrize("Kst,nz,nc,iters,use_kkt,shared,B", SHAPES)
def test_frozen_counts_equal_the_port(Kst, nz, nc, iters, use_kkt, shared, B):
    assert k1.round_flops(Kst, nz, nc, iters) == admm_kernel.round_flops(Kst, nz, nc, iters)
    assert k1.solve_flops_per_round(Kst, nz, nc, iters, use_kkt) == \
        admm_kernel.solve_flops_per_round(Kst, nz, nc, iters, use_kkt)
    for full in (True, False):
        assert k1.io_bytes(Kst, nz, nc, B, full, shared) == \
            admm_kernel.io_bytes(Kst, nz, nc, B, full, shared_hjk=shared)
    ops, nbytes = k1.launch_work(B, Kst, nz, nc, iters, use_kkt, shared)
    assert ops == B * admm_kernel.solve_flops_per_round(Kst, nz, nc, iters, use_kkt)
    assert nbytes == admm_kernel.io_bytes(Kst, nz, nc, B, True, shared_hjk=shared)


def test_peaks_are_the_bring_up_checks():
    text = (pathlib.Path(__file__).resolve().parents[2] / "chip_smoke.py").read_text()
    for name in ("PEAK_FP32_PER_S", "PEAK_BYTES_PER_S"):
        value = float(re.search(rf"^{name} = ([0-9.e]+)", text, re.M).group(1))
        assert getattr(peaks, name) == value
