"""Block-tridiagonal SPD factor-and-solve on the card: the hand-written CUDA
kernels, their wrapper and their plain PyTorch version.

Counterpart of the JAX package's ``ops/pallas/btridiag_kernel.py``
(``btridiag_solve_pallas``: three sweeps, factor in scratch) and
``ops/pallas/btridiag_kernel_v2.py`` (``btridiag_solve_pallas_v2``: two
sweeps, factor kept in the fast memory of the inputs). One function,

  ``btridiag_factor_solve(D, O, b, inplace=True)``  →  x = M⁻¹ b,
  M = tridiag(Oᵀ, D, O),  D [B, K, nz, nz], O [B, K-1, nz, nz], b [B, K, nz],

with the kernels of ``csrc/btridiag_kernel.cu`` behind it (see the source
note there). ``inplace=True`` is the two-sweep solve. Where the factor of a
warp's lanes fits shared memory (``solve_route``: every shape the solvers
meet) it launches the kernel that reads D, O, b batch-first as the caller has
them, gives nz threads to a lane and keeps the factor on chip: the wrapper
copies nothing. Longer horizons take the one-thread-per-lane kernel that
writes its factor over copies of D and O in a tile-major lane layout.
``inplace=False`` launches K3's kernel, whatever the shape: it too reads D,
O, b batch-first as the caller has them and writes x batch-first, gives every
lane a thread of its own (the whole batch in flight), and keeps the factor
and z in a scratch this wrapper allocates with ``torch.empty``
(``scratch_bytes_per_lane``, tile-major by 32 lanes). The caller's tensors
are never written on any route.

Dispatch rule: a CPU tensor takes the plain version
(``btridiag_factor_solve_plain``, the Python-loop recurrences of
``ops/btridiag.py``); a CUDA tensor launches a kernel or raises — there is
no fallback when the build or the launch fails, and the route is chosen from
the shapes, never from a failure. ``LAUNCHES`` counts kernel launches per
kernel, and nothing else. A block that is not positive definite gives NaN in
its lane, as the reference's square root does.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from control_box_rst_tpu_torch.ops.btridiag import btridiag_cholesky, btridiag_solve
from control_box_rst_tpu_torch.ops.cuda import build
from control_box_rst_tpu_torch.ops.cuda.layout import (
    LANE_TILE,
    from_kernel_layout,
    lane_tile,
    padded_lanes,
    ptr_array,
    to_kernel_layout,
)

# kernel launches per kernel (incremented where a kernel is launched, and
# nowhere else)
LAUNCHES: Dict[str, int] = {"btridiag_factor_solve": 0, "btridiag_factor_solve_inplace": 0}

SOURCE = build.CSRC / "btridiag_kernel.cu"


def build_spec(nz: int) -> build.Spec:
    """(source, defines) of the nz specialisation, as ``ops/cuda/build.py``
    takes it."""
    return SOURCE, {"NZ": nz}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def btridiag_factor_solve_plain(D, O, b):
    """x = M⁻¹ b by the block recurrences of ``ops/btridiag.py``: the plain
    version of both kernels (any float dtype, any device, any leading dims)."""
    return btridiag_solve(*btridiag_cholesky(D, O), b)


# --------------------------------------------------------------------------
# work counted from the loops of csrc/btridiag_kernel.cu (for roofline bounds)
# --------------------------------------------------------------------------

def factor_solve_flops(K: int, nz: int) -> int:
    """float32 operations of one lane, the same for both kernels (a
    multiply-subtract counts 2, a divide or a square root 1)."""
    chol = sum(2 * j + 2 + (nz - 1 - j) * (2 * j + 1) for j in range(nz))
    tri_vec = nz * nz                      # Σ_i (2i + 1)
    x_solve = nz * tri_vec                 # L X = O, nz columns
    schur = nz * (nz + 1) // 2 * 2 * nz    # S -= XᵀX, lower triangle
    coupling = 2 * nz * nz                 # Lo z  /  Loᵀ x
    per_stage = chol + 2 * tri_vec
    per_interval = x_solve + schur + 2 * coupling
    return K * per_stage + (K - 1) * per_interval


def io_bytes(K: int, nz: int, B: int) -> int:
    """Bytes the function must move: D, O, b read once, x written once
    (float32)."""
    return 4 * B * (K * nz * nz + (K - 1) * nz * nz + 2 * K * nz)


# --------------------------------------------------------------------------
# the two routes of the in-place solve, and the rule that picks one
# --------------------------------------------------------------------------

# Dynamic shared memory one block may ask for on an H100 (227 KB).
MAX_DYNAMIC_SMEM_BYTES = 232448
SMEM_ALIGN_FLOATS = 4
ROUTES = ("smem", "thread")

# what the last launch of each kernel chose (route, block shape, registers)
LAUNCH_INFO: Dict[str, dict] = {"btridiag_factor_solve": {}, "btridiag_factor_solve_inplace": {}}


def _round_up(floats: int) -> int:
    return -(-floats // SMEM_ALIGN_FLOATS) * SMEM_ALIGN_FLOATS


def factor_bytes_per_lane(K: int, nz: int) -> int:
    """Shared memory one lane takes on the shared-memory route of the
    in-place solve: the sum of the table ``BT_SMEM_LANE_ARRAYS`` of
    ``csrc/btridiag_kernel.cu`` (per stage one record of the diagonal factor,
    packed lower, with the reciprocals of its pivots; the sub-diagonal
    factors; z), every array rounded up to 16 bytes."""
    record = nz * (nz + 1) // 2 + nz
    floats = _round_up(K * record) + _round_up((K - 1) * nz * nz) + _round_up(K * nz)
    return 4 * floats


def scratch_bytes_per_lane(K: int, nz: int) -> int:
    """Scratch one lane takes on K3's kernel: the sum of the table
    ``K3_SCRATCH_LANE_ARRAYS`` of ``csrc/btridiag_kernel.cu`` (the diagonal
    factors packed lower, the sub-diagonal factors, z). The scratch is
    tile-major by ``LANE_TILE`` lanes, so it holds this for every lane of a
    batch rounded up to a whole tile."""
    return 4 * (K * nz * (nz + 1) // 2 + (K - 1) * nz * nz + K * nz)


def lanes_per_warp(nz: int) -> int:
    """Lanes a warp serves on the shared-memory route: nz threads per lane."""
    return 32 // nz


def solve_route(K: int, nz: int) -> str:
    """Which kernel ``inplace=True`` takes, from the shape alone: ``'smem'``
    (nz threads per lane, factor in shared memory) where the lanes of one
    warp fit the shared memory of a block, ``'thread'`` (one thread per
    lane, factor written over copies of D and O in device memory) otherwise —
    long horizons, or blocks wider than a warp."""
    if nz > 32:
        return "thread"
    fits = lanes_per_warp(nz) * factor_bytes_per_lane(K, nz)
    return "smem" if fits <= MAX_DYNAMIC_SMEM_BYTES else "thread"


# --------------------------------------------------------------------------
# load (built at first use by ops/cuda/build.py)
# --------------------------------------------------------------------------

def declare(lib: ctypes.CDLL, nz: int) -> None:
    """``restype`` / ``argtypes`` of the library's C functions, and a check
    that it is the nz specialisation."""
    c_i, c_p, c_ll = ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong
    lib.btridiag_kernel_nz.restype, lib.btridiag_kernel_nz.argtypes = c_i, []
    for fn in (lib.btridiag_smem_floats_per_lane, lib.btridiag_scratch_floats_per_lane):
        fn.restype, fn.argtypes = c_i, [c_i]
    lib.btridiag_factor_solve_inplace_launch.restype = c_i
    lib.btridiag_factor_solve_inplace_launch.argtypes = [c_p, c_ll, c_i, c_i, c_p]
    for fn in (lib.btridiag_factor_solve_smem_launch, lib.btridiag_factor_solve_scratch_launch):
        fn.restype = c_i
        fn.argtypes = [c_p, c_ll, c_i, c_ll, c_ll, c_ll, c_p, c_p]
    if lib.btridiag_kernel_nz() != nz:
        raise RuntimeError(f"library built for another nz than {nz}")


def _load(nz: int) -> ctypes.CDLL:
    return build.load(*build_spec(nz), lambda lib: declare(lib, nz))


# --------------------------------------------------------------------------
# wrapper
# --------------------------------------------------------------------------

def _check_args(D, O, b):
    if D.dim() != 4 or D.shape[-1] != D.shape[-2]:
        raise ValueError(f"D must be [B, K, nz, nz], got {tuple(D.shape)}")
    B, K, nz, _ = D.shape
    if K < 1:
        raise ValueError("need at least one stage")
    want = {"O": (B, K - 1, nz, nz), "b": (B, K, nz)}
    for name, a in (("O", O), ("b", b)):
        if tuple(a.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got {tuple(a.shape)}")
        if a.device != D.device:
            raise ValueError(f"{name} is on {a.device}, D on {D.device}")
        if a.dtype != D.dtype:
            raise ValueError(f"{name} is {a.dtype}, D is {D.dtype}")
    return B, K, nz


def _lane_strided(a: torch.Tensor):
    """``a`` [B, ...] as the shared-memory kernel reads it — every lane's
    array contiguous, lanes any distance apart, 0 included (one copy for the
    batch) — and that distance in elements. A tensor that already is such is
    returned as it is; anything else is copied once."""
    if a.shape[0] > 1 and a.stride(0) == 0:
        return a[0].contiguous(), 0
    if not a[0].is_contiguous():
        a = a.contiguous()
    return a, (a.stride(0) if a.shape[0] > 1 else 0)


def _launch_smem(lib, D, O, b, dims, stream):
    """Launch the shared-memory-route kernel of the in-place solve on the
    caller's batch-first tensors (no layout conversion; x allocated
    batch-first)."""
    B, K, nz = dims
    want = factor_bytes_per_lane(K, nz)
    have = 4 * lib.btridiag_smem_floats_per_lane(K)
    if have != want:
        raise RuntimeError(
            f"btridiag_factor_solve: the kernel carves {have} bytes of shared memory "
            f"per lane, factor_bytes_per_lane says {want}")
    (Dk, sD), (Ok, sO), (bk, sb) = (_lane_strided(a) for a in (D, O, b))
    x = torch.empty((B, K, nz), dtype=b.dtype, device=b.device)
    info = (ctypes.c_int * 4)()
    name = "btridiag_factor_solve_inplace"
    err = lib.btridiag_factor_solve_smem_launch(
        ptr_array([Dk, Ok, bk, x]), B, K, sD, sO, sb, info, stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: shared-memory kernel launch failed: CUDA error {err}")
    LAUNCH_INFO[name] = dict(
        route="smem", lanes_per_warp=lanes_per_warp(nz), smem_bytes_per_lane=want,
        smem_bytes_per_block=info[0], blocks=info[1], blocks_per_sm=info[2],
        registers_per_thread=info[3],
        resident_lanes_per_sm=info[2] * lanes_per_warp(nz),
    )
    return x


def _vector_aligned(a: torch.Tensor, stride: int, nz: int):
    """``a`` and its lane stride from ``_lane_strided``, as K3's kernel takes
    them: where nz % 4 == 0 the kernel moves blocks as 16-byte vectors, so
    every lane's array must start 16-byte aligned. Fresh allocations are; a
    view that is not (an offset into a larger buffer) is copied once."""
    if nz % 4 == 0 and (a.data_ptr() % 16 or stride % 4):
        a = a.clone(memory_format=torch.contiguous_format)
        stride = a.stride(0) if stride else 0
    return a, stride


def _launch_scratch(lib, D, O, b, dims, stream):
    """Launch K3's kernel on the caller's batch-first tensors (no layout
    conversion; x allocated batch-first, the scratch tile-major)."""
    B, K, nz = dims
    want = scratch_bytes_per_lane(K, nz)
    have = 4 * lib.btridiag_scratch_floats_per_lane(K)
    if have != want:
        raise RuntimeError(
            f"btridiag_factor_solve: the kernel carves {have} bytes of scratch per lane, "
            f"scratch_bytes_per_lane says {want}")
    (Dk, sD), (Ok, sO), (bk, sb) = (_vector_aligned(*_lane_strided(a), nz) for a in (D, O, b))
    x = torch.empty((B, K, nz), dtype=b.dtype, device=b.device)
    tiles = -(-B // LANE_TILE)
    scratch = torch.empty((tiles * LANE_TILE * want // 4,), dtype=torch.float32, device=b.device)
    info = (ctypes.c_int * 4)()
    name = "btridiag_factor_solve"
    err = lib.btridiag_factor_solve_scratch_launch(
        ptr_array([Dk, Ok, bk, x, scratch]), B, K, sD, sO, sb, info, stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}: scratch kernel launch failed: CUDA error {err}")
    LAUNCH_INFO[name] = dict(
        route="scratch", threads_per_lane=1, scratch_bytes_per_lane=want,
        blocks=info[0], threads_per_block=info[1],
        registers_per_thread=info[2], blocks_per_sm=info[3],
        resident_lanes_per_sm=info[3] * info[1],
    )
    return x


def _launch_thread(lib, D, O, b, dims, stream):
    """Launch the one-thread-per-lane kernel of the in-place solve: operands
    copied into the tile-major lane layout (the kernel writes its factor over
    those copies), x converted back."""
    B, K, nz = dims
    Dl, Ol, bl = (to_kernel_layout(a) for a in (D, O, b))
    xl = torch.empty((K * nz * padded_lanes(B),), dtype=torch.float32, device=D.device)
    name = "btridiag_factor_solve_inplace"
    err = lib.btridiag_factor_solve_inplace_launch(
        ptr_array([Dl, Ol, bl, xl]), B, K, lane_tile(B), stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"{name}_kernel launch failed: CUDA error {err}")
    LAUNCH_INFO[name] = dict(route="thread", lane_tile=lane_tile(B))
    return from_kernel_layout(xl, b.shape)


def btridiag_factor_solve(D, O, b, inplace: bool = True, route=None):
    """Solve M x = b for a batch of SPD block-tridiagonal M = tridiag(Oᵀ, D, O):
    factor, forward sweep and backward sweep in one kernel launch.

    D [B, K, nz, nz] (only the lower triangle of each block is read),
    O [B, K-1, nz, nz], b [B, K, nz] → x [B, K, nz]. Any strides are taken,
    D and O broadcast over B included; the caller's tensors are never
    written. ``inplace=True`` (the default, what the solvers call) is the
    two-sweep solve that keeps its factor where the backward sweep finds it:
    in shared memory (``route='smem'``, no copies in the wrapper) where
    ``solve_route`` says it fits, else over the wrapper's copies of D and O
    (``route='thread'``). ``inplace=False`` is K3's kernel, for every shape:
    one thread per lane, operands as the caller has them, the factor in a
    scratch. ``route=None`` follows the shape rule; naming a route is for
    checks of the in-place solve. Float32 only on the card."""
    dims = _check_args(D, O, b)
    B, K, nz = dims
    if route is not None and route not in ROUTES:
        raise ValueError(f"route must be one of {ROUTES} or None, got {route!r}")
    if D.device.type == "cpu":
        return btridiag_factor_solve_plain(D, O, b)
    if D.device.type != "cuda":
        raise RuntimeError(f"btridiag_factor_solve: unsupported device {D.device}")
    if D.dtype != torch.float32:
        raise TypeError(f"the CUDA kernels take float32, got {D.dtype}")
    if not inplace and route is not None:
        raise ValueError(f"route={route!r} names a kernel of the in-place solve; "
                         "inplace=False has one kernel")
    rule = solve_route(K, nz)
    if route == "smem" and rule != "smem":
        raise ValueError(
            "route='smem' needs a factor that fits shared memory "
            f"({lanes_per_warp(nz)} lanes of {factor_bytes_per_lane(K, nz)} bytes "
            f"in {MAX_DYNAMIC_SMEM_BYTES})")
    route = route or rule
    lib = _load(nz)
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        if not inplace:
            return _launch_scratch(lib, D, O, b, dims, stream)
        if route == "smem":
            return _launch_smem(lib, D, O, b, dims, stream)
        return _launch_thread(lib, D, O, b, dims, stream)
