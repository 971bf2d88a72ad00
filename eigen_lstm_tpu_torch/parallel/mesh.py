"""The model axis of tensor parallelism: a ``torch.distributed`` process
group, the port's counterpart of ``eigen_lstm_tpu/parallel/mesh.py``'s
``make_mesh(n, axis="model")``, and the raw collectives over it.

One process a device. On the card the group is NCCL's: its size and rank
come from ``torchrun``'s environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``), or, without it, the group is one process on one card. On
the CPU it is gloo's, meeting through a ``FileStore`` in a temporary
directory (or at ``store_path``, where spawned ranks meet), never at a
fixed TCP port. ``--tp N`` with N other than the group's size, or on the
card above ``torch.cuda.device_count()``, raises ``SystemExit`` with the
reason: there is no silent fall-back to one device.

At D = 1 the collectives still run through the group, so the code that
runs is the D > 1 code. ``group=None`` means no group at all, D = 1 with
no collective (the single-device tests of the TP functions).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass
class TPGroup:
    """The model axis: this process's rank, the axis size D and the device
    its shards live on. ``close`` ends the process group if this object
    started it."""

    rank: int
    size: int
    device: torch.device
    owns: bool = False
    tmpdir: Optional[str] = None

    def close(self):
        if self.owns and dist.is_initialized():
            dist.destroy_process_group()
        self.owns = False
        if self.tmpdir:
            shutil.rmtree(self.tmpdir, ignore_errors=True)
            self.tmpdir = None


def init_tp_group(n: int, device="cuda", store_path: Optional[str] = None,
                  rank: Optional[int] = None) -> TPGroup:
    """The model-axis group of ``--tp n`` on ``device`` (its type picks
    NCCL or gloo). ``store_path`` and ``rank``: a ``FileStore`` that n
    spawned processes share, each with its rank. A process group that is
    already up is used as it is."""
    dev = torch.device(device)
    if n < 1:
        raise SystemExit(f"--tp {n}: the model axis needs at least one device")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"--tp {n}: this machine shows "
                         f"{torch.cuda.device_count()} CUDA devices")
    env = os.environ
    if dist.is_initialized():
        world, me = dist.get_world_size(), dist.get_rank()
    elif "WORLD_SIZE" in env:
        world, me = int(env["WORLD_SIZE"]), int(env.get("RANK", "0"))
    elif store_path is not None:
        world, me = n, int(rank)
    else:
        world, me = 1, 0
    if world != n:
        raise SystemExit(
            f"--tp {n}: the model axis is one process a device, and this run "
            f"has {world} (start {n} with torchrun --nproc_per_node {n})")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return TPGroup(me, world, dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    tmpdir = None
    if "WORLD_SIZE" in env:
        dist.init_process_group(backend, init_method="env://", rank=me,
                                world_size=world)
    else:
        if store_path is None:
            tmpdir = tempfile.mkdtemp(prefix="tp_store_")
            store_path = os.path.join(tmpdir, "store")
        dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                                rank=me, world_size=world)
    return TPGroup(me, world, dev, owns=True, tmpdir=tmpdir)


# --- raw collectives (no autograd): parallel/tp.py wraps them -------------


def all_gather(x: torch.Tensor, dim: int, group: Optional[TPGroup]):
    """The D shards of ``x`` concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x)
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, group: Optional[TPGroup]):
    """The sum of ``x`` over the ranks (``jax.lax.psum``), a new tensor."""
    if group is None:
        return x
    y = x.reshape(-1).clone()
    dist.all_reduce(y)
    return y.reshape(x.shape)


def reduce_scatter(x: torch.Tensor, dim: int, group: Optional[TPGroup]):
    """This rank's chunk along ``dim`` of the sum of ``x`` over the ranks
    (``jax.lax.psum_scatter(..., tiled=True)``): NCCL's reduce-scatter,
    which moves one chunk a rank; gloo has none, so there an all-reduce,
    then the chunk."""
    if group is None:
        return x
    n = x.shape[dim] // group.size
    if dist.get_backend() != "nccl":
        return all_reduce(x, group).narrow(dim, group.rank * n, n).contiguous()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src)
    return out.movedim(0, dim).contiguous()
