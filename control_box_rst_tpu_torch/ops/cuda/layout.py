"""Lane layout of the one-thread-per-lane CUDA kernels.

The kernels of ``csrc/`` that run one thread per lane (one problem of the
batch) with the lane's state in device memory, for shapes whose state does
not fit shared memory — the box-QP kernels and the in-place
block-tridiagonal kernel — keep each per-lane array tile-major, ``[ceil(B/T), rows, T]``: with T = ``LANE_TILE`` a
warp is one tile, its 32 threads read 32 neighbouring floats at every access,
and its share of the array is one contiguous block. Batches smaller than a
warp take T = 1 (each lane's array contiguous). Those kernels compile both
instances; their wrappers convert in and out with these functions, which are
plain PyTorch and run on any device. The shared-memory kernels and K3's
kernel read and write batch-first tensors and do not come here (``ptr_array``
apart; K3 keeps its scratch tile-major by ``LANE_TILE`` lanes itself).
"""
from __future__ import annotations

import ctypes

import torch

LANE_TILE = 32


def lane_tile(B: int) -> int:
    """Tile width of a batch: a warp's worth of lanes, or 1 when the batch is
    smaller than that (each lane's arrays contiguous — the single-solve case)."""
    return LANE_TILE if B >= LANE_TILE else 1


def padded_lanes(B: int) -> int:
    T = lane_tile(B)
    return -(-B // T) * T


def to_kernel_layout(a: torch.Tensor) -> torch.Tensor:
    """[B, ...] → a fresh contiguous copy in the kernels' lane layout
    [ceil(B/T), rows, T]; any strides are accepted. The unused lanes of a
    ragged last tile are allocated and left uninitialised: no thread reads or
    computes them."""
    B, T = a.shape[0], lane_tile(a.shape[0])
    a = a.reshape(B, -1)
    rows, full = a.shape[1], B // T
    out = a.new_empty((padded_lanes(B) // T, rows, T))
    if full:
        out[:full].transpose(1, 2).copy_(a[: full * T].reshape(full, T, rows))
    if full * T != B:
        out[full, :, : B - full * T].copy_(a[full * T:].t())
    return out


def from_kernel_layout(a: torch.Tensor, shape) -> torch.Tensor:
    """Inverse of ``to_kernel_layout`` for an array of [B, ...] ``shape``."""
    B, T = shape[0], lane_tile(shape[0])
    a = a.view(padded_lanes(B) // T, -1, T)
    rows, full = a.shape[1], B // T
    out = a.new_empty((B, rows))
    if full:
        out[: full * T].view(full, T, rows).copy_(a[:full].transpose(1, 2))
    if full * T != B:
        out[full * T:].copy_(a[full, :, : B - full * T].t())
    return out.view(shape)


def ptr_array(tensors):
    """Host array of the tensors' device pointers, the form the C entry
    points take."""
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))
