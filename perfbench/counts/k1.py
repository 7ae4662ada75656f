"""Work of one K1 launch (the box-QP solve, ``csrc/admm_kernel.cu``), counted
from the kernel's loops: a frozen copy of ``round_flops``,
``solve_flops_per_round`` and ``io_bytes`` of the port's
``ops/cuda/admm_kernel.py`` as they stood when the benchmark was defined, so
that a change to the program cannot change the yardstick
(``perfbench/tests/test_perfbench_counts.py`` holds them equal today).

``launch_work`` is the count the roofline reads: per lane one factorisation
and one rho-round of ``iters`` ADMM iterations with the recentering and exit
test, every input read once and every output written once, Hd/J/K once when
the batch shares them. It depends on the launch's shapes alone, so it is the
same whatever implements the solve, and no implementation can be credited
with more work than the shapes ask for.
"""
from __future__ import annotations


def round_flops(Kst: int, nz: int, nc: int, iters: int) -> int:
    """float32 operations of one ρ-round of one lane, counted from the loops
    of ``round_ops`` (a multiply-add counts 2, a divide / sqrt / max / compare
    counts 1)."""
    N = Kst - 1
    ntri = nz * (nz + 1) // 2
    # assemble D (lower): J'J and K'K terms 3 ops per (r, entry), diag 2
    asm = Kst * (2 * ntri * nc * 3 + 2 * nz)
    # X = L^-1 O: O entries (2nc) + rho_eq, substitution nz(nz-1) per column + div
    xsolve = N * nz * (nz * (2 * nc) + nz * (nz - 1) + nz)
    schur = N * ntri * 2 * nz
    chol = Kst * (nz ** 3 // 3 + 2 * nz)
    factor = asm + xsolve + schur + chol
    fwd = Kst * (nz * 5) + N * nc * (2 + 2 * nz) + N * nc * 2 * nz \
        + N * 2 * nz * nz + Kst * (nz * (nz - 1) + nz)
    bwd = N * 2 * nz * nz + Kst * (nz * (nz - 1) + nz)
    upd = N * nc * (4 * nz + 6) + Kst * nz * 14
    resid = N * nc * (4 * nz + 3) + Kst * nz * 13
    return factor + iters * (fwd + bwd + upd) + resid


def solve_flops_per_round(Kst: int, nz: int, nc: int, iters: int, use_kkt: bool) -> int:
    """As ``round_flops`` plus the recentering and exit test of the full solve."""
    N = Kst - 1
    recenter = N * nc * 4 * nz + Kst * nz * (2 * nz + 5)
    kkt = (N * nc * (2 + 4 * nz) + Kst * nz * 4) if use_kkt else 0
    return round_flops(Kst, nz, nc, iters) + recenter + kkt + 12


def io_bytes(Kst: int, nz: int, nc: int, B: int, full_solve: bool,
             shared_hjk: bool = False) -> int:
    """Bytes the function must move: every input read once, every output
    written once (float32). With ``shared_hjk`` Hd, J, K are one copy for
    the batch, not one per lane."""
    N = Kst - 1
    hjk = Kst * nz * nz + 2 * N * nc * nz
    inputs = Kst * nz + N * nc + 2 * Kst * nz + 1 + 3 * Kst * nz + N * nc
    outputs = 3 * Kst * nz + N * nc + (3 if full_solve else 2)
    return 4 * (B * (inputs + outputs) + (1 if shared_hjk else B) * hjk)


def launch_work(B: int, Kst: int, nz: int, nc: int, iters: int, use_kkt: bool,
                shared_hjk: bool):
    """(float32 operations, bytes) that one K1 launch over B lanes needs."""
    ops = B * solve_flops_per_round(Kst, nz, nc, iters, use_kkt)
    return ops, io_bytes(Kst, nz, nc, B, True, shared_hjk)
