"""Device mesh construction and batch sharding, over ``torch.distributed``.

Counterpart of the JAX package's ``parallel/mesh.py``. There one controller
lays the sweep's batch axis over a ``jax.sharding.Mesh`` of every local chip;
here the mesh is a ``torch.distributed`` ``DeviceMesh`` with one process per
rank (as under ``torchrun --nproc-per-node``), so that each card has its own
host thread: the port's nonlinear and closed-loop paths are host-bound, and
one interpreter driving several cards would serialise their dispatch.

Mesh axes: ('batch',) is the only axis the MPC workload needs. The
counterparts of the reference's shardings are the ``DTensor`` placements:
``P('batch')`` is ``(Shard(0),)`` and ``P()`` is ``(Replicate(),)``. Every
lane is independent, so a sharded solve runs the single-device solve on the
rank's own lanes with no collective; gathering (``gather_batch``) is the
caller's to ask for.

Backends: ``nccl`` when every rank of a host has a card of its own, ``gloo``
on the CPU and when ranks share a card (NCCL refuses two ranks on one GPU).
"""
from __future__ import annotations

import os
import pickle
import tempfile
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from control_box_rst_tpu_torch.utils.precision import resolve_device


def _device_type(device_type) -> str:
    """``None`` → ``cuda`` (raises without a card); ``"cpu"`` has to be
    asked for."""
    return resolve_device(None if device_type is None else device_type).type


def _backend(device_type: str, ranks_on_host: int) -> str:
    if device_type == "cuda" and ranks_on_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def _pin_card(device_type: str, local_rank: int) -> None:
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("batch",),
    devices: Optional[Sequence[int]] = None,
    device_type: Optional[str] = None,
) -> DeviceMesh:
    """Build a mesh over every rank of the job (or the ranks in ``devices``).
    Default: 1-D 'batch' over the world size.

    Without a process group, one is created: from the ``torchrun``
    environment when it is set, else a one-rank group, so that ``make_mesh()``
    in a plain script is the one-device mesh. ``device_type=None`` means
    ``cuda`` and raises without a card; ``"cpu"`` has to be asked for."""
    device_type = _device_type(device_type)
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            local_rank = int(os.environ.get("LOCAL_RANK", 0))
            on_host = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
            _pin_card(device_type, local_rank)
            dist.init_process_group(_backend(device_type, on_host), init_method="env://")
        else:
            _pin_card(device_type, 0)
            dist.init_process_group(_backend(device_type, 1), store=dist.HashStore(),
                                    rank=0, world_size=1)
    ranks = list(range(dist.get_world_size())) if devices is None else list(devices)
    if shape is None:
        shape = (len(ranks),) + (1,) * (len(axis_names) - 1)
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axis_names))


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_sharding(mesh: DeviceMesh, axis: str = "batch"):
    """Placements that split the leading (batch) dimension over ``axis``."""
    return tuple(Shard(0) if name == axis else Replicate() for name in mesh.mesh_dim_names)


def replicated(mesh: DeviceMesh):
    return tuple(Replicate() for _ in range(mesh.ndim))


def _tree_map(fn, x):
    if isinstance(x, dict):
        return {k: _tree_map(fn, v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_tree_map(fn, v) for v in x))
    if isinstance(x, (tuple, list)):
        return type(x)(_tree_map(fn, v) for v in x)
    return fn(x)


def _lane_window(mesh: DeviceMesh, total: int, axis: str):
    """(offset, count) of this rank's lanes of a batch of ``total`` lanes."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if total % n:
        raise ValueError(
            f"a batch of {total} lanes does not split over {n} ranks "
            "(pad it with pad_to_multiple)")
    count = total // n
    return mesh.get_local_rank(axis) * count, count


def shard_batch(x, mesh: DeviceMesh, axis: str = "batch"):
    """Place a batched pytree (tensors or numpy arrays; every rank holds the
    whole batch) with its leading axis sharded over the mesh: each leaf
    becomes a ``Shard(0)`` DTensor whose local tensor is this rank's lanes,
    on the mesh's device. No collective. A batch that the axis does not
    divide raises ``ValueError``."""
    device = mesh_device(mesh)

    def one(a):
        a = torch.as_tensor(a, device=device)
        off, count = _lane_window(mesh, a.shape[0], axis)
        return DTensor.from_local(a[off:off + count].contiguous(), mesh,
                                  batch_sharding(mesh, axis))
    return _tree_map(one, x)


def local_batch(x, mesh: DeviceMesh, axis: str = "batch"):
    """(this rank's lanes, their offset in the batch, the batch's size) of a
    ``Shard(0)`` DTensor, or of a whole batch, which is sharded first."""
    if not isinstance(x, DTensor):
        x = shard_batch(x, mesh, axis)
    total = x.shape[0]
    off, _ = _lane_window(mesh, total, axis)
    return x.to_local(), off, total


def from_local_batch(x, mesh: DeviceMesh, axis: str = "batch"):
    """Every tensor of a pytree of this rank's lanes as a ``Shard(0)``
    DTensor over the mesh (the counterpart of ``shard_map``'s
    ``out_specs=P('batch')``). No collective: the shards are equal in size."""
    return _tree_map(
        lambda a: DTensor.from_local(a.contiguous(), mesh, batch_sharding(mesh, axis))
        if isinstance(a, torch.Tensor) else a, x)


def gather_batch(x, axis: str = "batch"):
    """Every ``Shard(0)`` DTensor of a pytree as the whole batch, on every
    rank (a tensor on the mesh's device). This is ``DTensor.full_tensor``
    through c10d's ``all_gather`` over the axis's group: under gloo with CUDA
    tensors (ranks sharing a card) the functional collective behind
    ``full_tensor`` crashes the process (SIGSEGV in ``wait_tensor``, torch
    2.11), and c10d's collective takes them."""
    def one(a):
        if not isinstance(a, DTensor):
            return a
        local = a.to_local().contiguous()
        group = a.device_mesh.get_group(axis)
        parts = [torch.empty_like(local) for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, local, group=group)
        return torch.cat(parts)
    return _tree_map(one, x)


def pad_to_multiple(x, multiple: int, axis: int = 0):
    """Pad the batch axis so it divides the device count (returns (x, n_pad))."""
    n = x.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return x, 0
    pad_widths = [(0, 0)] * x.ndim
    pad_widths[axis] = (0, rem)
    return np.pad(np.asarray(x), pad_widths, mode="edge"), rem


def _rank_main(rank, fn, world_size, device_type, workdir, args):
    torch.set_num_threads(1)
    _pin_card(device_type, rank)
    dist.init_process_group(_backend(device_type, world_size),
                            init_method=f"file://{os.path.join(workdir, 'store')}",
                            rank=rank, world_size=world_size)
    try:
        out = fn(rank, *args)
        with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn: Callable, world_size: int, args=(), device_type: Optional[str] = None,
                timeout_s: float = 300.0, workdir: Optional[str] = None) -> list:
    """Run ``fn(rank, *args)`` in ``world_size`` processes of this host (the
    spawn start method), each a rank of one process group (``file://`` store
    in ``workdir``, a temporary directory by default; one thread each; the
    card pinned as ``make_mesh`` pins it), and return what each rank
    returned, in rank order. ``fn`` and its results must pickle. A rank that
    raises fails the call, and ranks still running after ``timeout_s`` are
    killed and raise ``TimeoutError``."""
    device_type = _device_type(device_type)
    if workdir is None:
        with tempfile.TemporaryDirectory(prefix="mesh_") as tmp:
            return spawn_ranks(fn, world_size, args, device_type, timeout_s, tmp)
    os.makedirs(workdir, exist_ok=True)
    ctx = torch.multiprocessing.start_processes(
        _rank_main, args=(fn, world_size, device_type, str(workdir), tuple(args)),
        nprocs=world_size, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=max(0.0, min(5.0, deadline - time.monotonic()))):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join()
            raise TimeoutError(f"{world_size} ranks did not finish in {timeout_s} s")
    results = []
    for r in range(world_size):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results
