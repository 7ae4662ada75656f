"""PyTorch port vs JAX package: the block-tridiagonal factor-and-solve.

``ops/cuda/btridiag_kernel.py`` stands for both Pallas kernels of the JAX
package: ``btridiag_solve_pallas`` (three sweeps) and
``btridiag_solve_pallas_v2`` (two sweeps, factor in place). Here, on the CPU,
the wrapper takes its plain version; it is held against both Pallas kernels
run in interpret mode on the shapes of tests/test_pallas_kernels.py (the same
numpy inputs from a seed, float32, atol 5e-6: well-conditioned systems, the
two sides differ by the rounding of reordered sums), and the wrapper's
argument checks are exercised. The CUDA kernels themselves are built and held
against the plain version on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from control_box_rst_tpu.ops.pallas.btridiag_kernel import btridiag_solve_pallas
from control_box_rst_tpu.ops.pallas.btridiag_kernel_v2 import btridiag_solve_pallas_v2
from control_box_rst_tpu_torch.ops import btridiag as tbt
from control_box_rst_tpu_torch.ops.cuda import btridiag_kernel as bk

from torch_port_util import to_np

torch.set_num_threads(1)

# (seed, B, K, nz, diagonal shift, off-diagonal scale, three-sweep tile)
SHAPES = {
    "B5_K13_nz4": (3, 5, 13, 4, 10.0, 0.3, 8),
    "B3_K7_nz3": (5, 3, 7, 3, 8.0, 0.2, 4),
}
PALLAS = {
    "three_sweeps": lambda D, O, b, tile: btridiag_solve_pallas(
        D, O, b, tile_b=tile, interpret=True),
    "two_sweeps_inplace": lambda D, O, b, tile: btridiag_solve_pallas_v2(
        D, O, b, tile_b=1024, interpret=True),
}


def _system(name, dtype=np.float32):
    seed, B, K, nz, shift, off, tile = SHAPES[name]
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((B, K, nz, nz)).astype(dtype)
    D = D @ D.transpose(0, 1, 3, 2) + shift * np.eye(nz, dtype=dtype)
    O = (off * rng.standard_normal((B, K - 1, nz, nz))).astype(dtype)
    b = rng.standard_normal((B, K, nz)).astype(dtype)
    return D, O, b, tile


@pytest.mark.parametrize("kernel", sorted(PALLAS))
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_factor_solve_matches_pallas_interpret(shape, kernel):
    D, O, b, tile = _system(shape)
    out_j = PALLAS[kernel](jnp.asarray(D), jnp.asarray(O), jnp.asarray(b), tile)
    Dt, Ot, bt = (torch.from_numpy(a) for a in (D, O, b))
    out_t = bk.btridiag_factor_solve(Dt, Ot, bt, inplace=kernel == "two_sweeps_inplace")
    assert out_t.dtype == torch.float32 and out_t.shape == bt.shape
    np.testing.assert_allclose(to_np(out_t), np.asarray(out_j), rtol=0, atol=5e-6)
    # the caller's tensors are never written, whichever kernel is asked for
    assert np.array_equal(to_np(Dt), D) and np.array_equal(to_np(Ot), O)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_plain_version_solves_the_dense_system(shape):
    """x = M⁻¹ b against a dense float64 solve, lane by lane (1e-10)."""
    D, O, b, _ = _system(shape, np.float64)
    x = bk.btridiag_factor_solve_plain(*(torch.from_numpy(a) for a in (D, O, b)))
    for i in range(D.shape[0]):
        M = to_np(tbt.btridiag_dense(torch.from_numpy(D[i]), torch.from_numpy(O[i])))
        want = np.linalg.solve(M, b[i].reshape(-1)).reshape(b[i].shape)
        np.testing.assert_allclose(to_np(x[i]), want, rtol=0, atol=1e-10)


def test_cpu_tensor_takes_the_plain_version_and_counts_no_launch():
    D, O, b, _ = _system("B5_K13_nz4")
    args = [torch.from_numpy(a) for a in (D, O, b)]
    bk.reset_launch_counts()
    for inplace in (True, False):
        out = bk.btridiag_factor_solve(*args, inplace=inplace)
        assert torch.equal(out, bk.btridiag_factor_solve_plain(*args))
    assert bk.LAUNCHES == {"btridiag_factor_solve": 0, "btridiag_factor_solve_inplace": 0}
    # float64 is fine on the CPU (the kernels' float32 rule is the card's)
    out64 = bk.btridiag_factor_solve(*(a.double() for a in args))
    assert out64.dtype == torch.float64
    np.testing.assert_allclose(to_np(out64), to_np(out), rtol=0, atol=5e-6)


def test_broadcast_and_strided_operands_are_accepted():
    """D and O shared by all lanes (stride 0 over B) and a transposed b give
    what their contiguous copies give."""
    D, O, b, _ = _system("B5_K13_nz4")
    D0, O0 = torch.from_numpy(D[0]), torch.from_numpy(O[0])
    bt = torch.from_numpy(np.ascontiguousarray(b.transpose(1, 0, 2))).transpose(0, 1)
    assert not bt.is_contiguous()
    De, Oe = D0.expand((5,) + D0.shape), O0.expand((5,) + O0.shape)
    out = bk.btridiag_factor_solve(De, Oe, bt)
    want = bk.btridiag_factor_solve(De.contiguous(), Oe.contiguous(), bt.contiguous())
    assert torch.equal(out, want)


@pytest.mark.parametrize("case", ["D_rank", "D_square", "O_stages", "b_width",
                                  "b_dtype", "no_stage"])
def test_wrapper_refuses_malformed_operands(case):
    D, O, b, _ = _system("B3_K7_nz3")
    D, O, b = (torch.from_numpy(a) for a in (D, O, b))
    bad = {
        "D_rank": (D[0], O, b, ValueError),
        "D_square": (D[..., :2], O, b, ValueError),
        "O_stages": (D, O[:, :-1], b, ValueError),
        "b_width": (D, O, b[..., :2], ValueError),
        "b_dtype": (D, O, b.double(), ValueError),
        "no_stage": (D[:, :0], O[:, :0], b[:, :0], ValueError),
    }[case]
    with pytest.raises(bad[3]):
        bk.btridiag_factor_solve(*bad[:3])


def test_not_positive_definite_block_gives_nan_in_its_lane_only():
    """The reference takes the square root of a negative pivot (NaN, no
    clamp); so does the plain version, and the other lanes are untouched."""
    D, O, b, _ = _system("B5_K13_nz4")
    D[2, 4] = -np.eye(4, dtype=np.float32)
    out = bk.btridiag_factor_solve(*(torch.from_numpy(a) for a in (D, O, b)))
    assert bool(torch.isnan(out[2]).any())
    assert bool(torch.isfinite(out[[0, 1, 3, 4]]).all())


def test_single_stage_system():
    D, O, b, _ = _system("B3_K7_nz3", np.float64)
    D, O, b = (torch.from_numpy(a[:, :1]) for a in (D, O[:, :0], b))
    x = bk.btridiag_factor_solve(D, O, b)
    np.testing.assert_allclose(
        to_np(x[:, 0]), np.linalg.solve(to_np(D[:, 0]), to_np(b[:, 0])[..., None])[..., 0],
        rtol=0, atol=1e-12)


def test_work_counts_follow_the_kernel_loops():
    """Roofline counters at the flagship shapes: 8,096 bytes per lane in and
    out, and operations linear in the stages."""
    assert bk.io_bytes(51, 4, 1) == 8096
    assert bk.io_bytes(51, 4, 32768) == 32768 * 8096
    f = [bk.factor_solve_flops(K, 4) for K in (1, 2, 3)]
    assert f[0] == 34 + 2 * 16 and f[2] - f[1] == f[1] - f[0] == 66 + 64 + 80 + 64
    assert bk.factor_solve_flops(51, 4) == 51 * 66 + 50 * 208


@pytest.mark.parametrize("route", [None, "smem", "thread"])
@pytest.mark.parametrize("inplace", [True, False])
def test_naming_a_route_changes_nothing_on_the_cpu(inplace, route):
    D, O, b, _ = _system("B5_K13_nz4")
    args = [torch.from_numpy(a) for a in (D, O, b)]
    bk.reset_launch_counts()
    out = bk.btridiag_factor_solve(*args, inplace=inplace, route=route)
    assert torch.equal(out, bk.btridiag_factor_solve_plain(*args))
    assert bk.LAUNCHES == {"btridiag_factor_solve": 0, "btridiag_factor_solve_inplace": 0}


def test_factor_bytes_at_the_flagship_shapes():
    """K=51, nz=4: 51 records of 14 floats (rounded up to 716), 50 blocks of
    16, z 204: 6,880 bytes a lane, eight lanes to a warp, four warps to an SM."""
    assert bk.factor_bytes_per_lane(51, 4) == 4 * (716 + 800 + 204) == 6880
    assert bk.lanes_per_warp(4) * bk.factor_bytes_per_lane(51, 4) <= bk.MAX_DYNAMIC_SMEM_BYTES // 4
    assert bk.solve_route(51, 4) == "smem" and bk.solve_route(1001, 4) == "thread"
