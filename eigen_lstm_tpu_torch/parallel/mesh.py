"""The process mesh of the port's parallel training and the raw collectives
over its axes: the counterpart of ``eigen_lstm_tpu/parallel/mesh.py``'s
``make_mesh`` and of ``parallel/dp_tp.py``'s ``make_mesh_2d``.

One process a device. An axis is an ``AxisGroup``: this process's rank on
it, the axis size and the ``torch.distributed`` group its collectives run
on. ``--tp N`` alone is one axis, the model axis, over the default group
(``init_tp_group``). ``--dp N``, alone or with ``--tp M``, is a
``ProcessMesh`` of N data rows by M model columns (M = 1 for ``--dp``
alone), rank = d * M + m, the row-major order of the JAX ``make_mesh_2d``;
each row is a model group and each column a data group, each a
``dist.new_group``, so a collective reduces over its own axis and never
over all N * M ranks.

On the card the groups are NCCL's: the size and rank come from
``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), or,
without it, the run is one process on one card. On the CPU they are
gloo's, meeting through a ``FileStore`` in a temporary directory (or at
``store_path``, where spawned ranks meet), never at a fixed TCP port. A
mesh whose size differs from the run's process count, or that asks on the
card for more devices than ``torch.cuda.device_count()``, raises
``SystemExit`` with the reason: there is no silent fall-back to one device.

At size 1 the collectives still run through their group, so the code that
runs is the code of larger axes. ``group=None`` means no group at all,
size 1 with no collective (the single-device tests of the TP functions).
"""

from __future__ import annotations

import dataclasses
import os
import shutil
import tempfile
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..config import MeshConfig


@dataclasses.dataclass
class AxisGroup:
    """One axis of the mesh: this process's rank on it, the axis size, the
    device its shards live on and the process group of its collectives
    (``pg`` None: the default group, every process of the run). ``close``
    ends the process group if this object started it."""

    rank: int
    size: int
    device: torch.device
    owns: bool = False
    tmpdir: Optional[str] = None
    pg: Any = None

    def close(self):
        _close(self)


# the model axis: the whole run under ``--tp N`` alone, a mesh's row under
# ``--dp N --tp M``
TPGroup = AxisGroup


@dataclasses.dataclass
class ProcessMesh:
    """``--dp N`` (``model`` None) or ``--dp N --tp M``: the data axis and
    the model axis of this process, rank = d * M + m."""

    data: AxisGroup
    model: Optional[AxisGroup]
    device: torch.device
    owns: bool = False
    tmpdir: Optional[str] = None

    @property
    def rank(self) -> int:
        m = self.model
        return self.data.rank * (m.size if m else 1) + (m.rank if m else 0)

    def close(self):
        _close(self)


def _close(obj):
    if obj.owns and dist.is_initialized():
        dist.destroy_process_group()
    obj.owns = False
    if obj.tmpdir:
        shutil.rmtree(obj.tmpdir, ignore_errors=True)
        obj.tmpdir = None


def _start(n: int, device, store_path: Optional[str], rank: Optional[int],
           flags: str, axis: str):
    """The process group of a run of ``n`` processes on ``device`` (its type
    picks NCCL or gloo): (rank, device, owns, tmpdir). A process group that
    is already up is used as it is."""
    dev = torch.device(device)
    if n < 1:
        raise SystemExit(f"{flags}: {axis} needs at least one device")
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(f"{flags}: this machine shows "
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
            f"{flags}: {axis} is one process a device, and this run "
            f"has {world} (start {n} with torchrun --nproc_per_node {n})")
    if dev.type == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", dev.index or 0)))
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return me, dev, False, None
    backend = "nccl" if dev.type == "cuda" else "gloo"
    tmpdir = None
    if "WORLD_SIZE" in env:
        dist.init_process_group(backend, init_method="env://", rank=me,
                                world_size=world)
    else:
        if store_path is None:
            tmpdir = tempfile.mkdtemp(prefix="mesh_store_")
            store_path = os.path.join(tmpdir, "store")
        dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                                rank=me, world_size=world)
    return me, dev, True, tmpdir


def init_tp_group(n: int, device="cuda", store_path: Optional[str] = None,
                  rank: Optional[int] = None) -> AxisGroup:
    """The model axis of ``--tp n`` alone on ``device``, over the default
    group. ``store_path`` and ``rank``: a ``FileStore`` that n spawned
    processes share, each with its rank."""
    me, dev, owns, tmpdir = _start(n, device, store_path, rank, f"--tp {n}",
                                   "the model axis")
    return AxisGroup(me, n, dev, owns, tmpdir)


def init_mesh(cfg: MeshConfig, device="cuda") -> ProcessMesh:
    """The mesh of ``--dp N`` (``cfg.model_devices`` None) or ``--dp N --tp
    M`` on ``device``, over the run's processes (a process group that is
    up, ``torchrun``'s, or one process): every process creates every row's
    and column's group, in the same order, as ``dist.new_group``
    requires."""
    m_size, n_data = cfg.model_devices or 1, cfg.num_devices
    flags = f"--dp {n_data}" + (f" --tp {m_size}" if cfg.model_devices else "")
    me, dev, owns, tmpdir = _start(n_data * m_size, device, None, None,
                                   flags, "the mesh")
    d, m = divmod(me, m_size)
    data_pg = model_pg = None
    for col in range(m_size):
        pg = dist.new_group([row * m_size + col for row in range(n_data)])
        if col == m:
            data_pg = pg
    model = None
    if cfg.model_devices:
        for row in range(n_data):
            pg = dist.new_group([row * m_size + col for col in range(m_size)])
            if row == d:
                model_pg = pg
        model = AxisGroup(m, m_size, dev, pg=model_pg)
    return ProcessMesh(AxisGroup(d, n_data, dev, pg=data_pg), model, dev,
                       owns, tmpdir)


# --- raw collectives (no autograd): parallel/tp.py wraps them -------------


def all_gather(x: torch.Tensor, dim: int, group: Optional[AxisGroup]):
    """The axis's shards of ``x`` concatenated along ``dim`` in rank order
    (``jax.lax.all_gather(..., tiled=True)``)."""
    if group is None:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(group.size)]
    dist.all_gather(parts, x, group=group.pg)
    return torch.cat(parts, dim)


def all_reduce(x: torch.Tensor, group: Optional[AxisGroup]):
    """The sum of ``x`` over the axis (``jax.lax.psum``), a new tensor."""
    if group is None:
        return x
    y = x.reshape(-1).clone()
    dist.all_reduce(y, group=group.pg)
    return y.reshape(x.shape)


def reduce_scatter(x: torch.Tensor, dim: int, group: Optional[AxisGroup]):
    """This rank's chunk along ``dim`` of the sum of ``x`` over the axis
    (``jax.lax.psum_scatter(..., tiled=True)``): NCCL's reduce-scatter,
    which moves one chunk a rank; gloo has none, so there an all-reduce,
    then the chunk."""
    if group is None:
        return x
    n = x.shape[dim] // group.size
    if dist.get_backend(group.pg) != "nccl":
        return all_reduce(x, group).narrow(dim, group.rank * n, n).contiguous()
    src = x.movedim(dim, 0).contiguous()
    out = src.new_empty((n,) + src.shape[1:])
    dist.reduce_scatter_tensor(out, src, group=group.pg)
    return out.movedim(0, dim).contiguous()


def all_true(flag: bool, device) -> bool:
    """Whether ``flag`` holds on every process of the run (the default
    group): the ranks of a mesh take the same branch after a check each
    computed on its own."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())
