"""The process mesh of the port's parallel training and the raw collectives
over its axes: the counterpart of ``eigen_lstm_tpu/parallel/mesh.py``'s
``make_mesh`` and of ``parallel/dp_tp.py``'s ``make_mesh_2d``.

One process a device. An axis is an ``AxisGroup``: this process's rank on
it, the axis size and the ``torch.distributed`` group its collectives run
on. ``--tp N`` alone is one axis, the model axis, over the default group
(``init_tp_group``). ``--dp N``, ``--sp N`` or ``--pp N`` alone,
``--dp N`` or ``--sp N`` with ``--tp M``, ``--dp N --sp M`` and ``--dp N
--pp M`` are ``ProcessMesh`` es of rows by columns (``init_mesh``): N data
rows by M model, seq or stage columns (M = 1 for ``--dp`` alone), N seq
rows by M model columns (M = 1 for ``--sp`` alone), or N stage rows
(``--pp`` alone), rank = row * M + column, the row-major order of the JAX
``make_mesh_2d`` (``make_mesh_dp_sp``, ``make_mesh_tp_sp``,
``make_mesh_dp_pp``); each row and each column is a ``dist.new_group``, so
a collective reduces over its own axis and never over all N * M ranks. The
seq and stage axes also have point-to-point ``send`` and ``recv`` between
neighbours and a ``broadcast``.

On the card the groups are NCCL's: the size and rank come from
``torchrun``'s environment (``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK``), or,
without it, the run is one process on one card. On the CPU they are
gloo's, meeting through a ``FileStore`` in a temporary directory (or at
``store_path``, where spawned ranks meet), never at a fixed TCP port. A
mesh whose size differs from the run's process count, or that asks on the
card for more devices than ``torch.cuda.device_count()``, raises
``SystemExit`` with the reason: there is no silent fall-back to one device.

An axis also holds the exchange buffers that K15 and K16 store into at
D > 1 (``exchange``, made and keyed by ``ops/cuda_tp_seq.py``: one
``cudaMalloc`` a rank, the peers' mapped through CUDA IPC); closing the
axis, or the mesh that holds it, releases them before its process group
ends. ``close(failed=True)``, for a run that ends on an error, runs no
collective: it unmaps the peers' buffers and leaves the rest to the
process's end. The process group ends even when releasing a buffer
raises.

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
    (``pg`` None: the default group, every process of the run), and the
    kernels' exchange buffers over it, by key, each with a ``close``.
    ``close`` releases those, then ends the process group if this object
    started it (``failed``: the run ends on an error)."""

    rank: int
    size: int
    device: torch.device
    owns: bool = False
    tmpdir: Optional[str] = None
    pg: Any = None
    exchange: dict = dataclasses.field(default_factory=dict)

    def close(self, failed: bool = False):
        _close(self, failed)


# the model axis: the whole run under ``--tp N`` alone, a mesh's row under
# ``--dp N --tp M``
TPGroup = AxisGroup


@dataclasses.dataclass
class ProcessMesh:
    """The axes of this process: ``--dp N`` (``model``, ``seq`` and
    ``stage`` None), ``--dp N --tp M``, ``--dp N --sp M``, ``--dp N --pp
    M``, ``--sp N``, ``--sp N --tp M`` or ``--pp N`` (``data`` None).
    rank = ((d * S + s) * P + p) * M + m, an absent axis of size 1 and
    rank 0."""

    data: Optional[AxisGroup]
    model: Optional[AxisGroup]
    device: torch.device
    owns: bool = False
    tmpdir: Optional[str] = None
    seq: Optional[AxisGroup] = None
    stage: Optional[AxisGroup] = None

    @property
    def rank(self) -> int:
        r = 0
        for axis in (self.data, self.seq, self.stage, self.model):
            if axis is not None:
                r = r * axis.size + axis.rank
        return r

    def close(self, failed: bool = False):
        _close(self, failed)


def _close(obj, failed: bool = False):
    axes = [obj] if isinstance(obj, AxisGroup) else [
        obj.data, obj.seq, obj.stage, obj.model]
    err = None
    try:
        for axis in axes:
            if axis is not None:
                buffers, axis.exchange = list(axis.exchange.values()), {}
                for b in buffers:
                    try:
                        b.close(failed)
                    except Exception as e:
                        # the card has failed: the other buffers are
                        # released without a collective, then it is raised
                        failed, err = True, err or e
        if err is not None:
            raise err
    finally:
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
    """The mesh of ``--dp N``, ``--sp N`` or ``--pp N`` alone, of ``--dp
    N`` or ``--sp N`` with ``--tp M``, or of ``--dp N --sp M`` or ``--dp N
    --pp M`` (``cfg.num_devices`` None: no data axis), on ``device``, over
    the run's processes (a process group that is up, ``torchrun``'s, or one
    process): every process creates every column's group, then every
    row's, in the same order, as ``dist.new_group`` requires."""
    axes = [(name, flag, size) for name, flag, size in (
        ("data", "--dp", cfg.num_devices), ("seq", "--sp", cfg.seq_devices),
        ("stage", "--pp", cfg.stage_devices),
        ("model", "--tp", cfg.model_devices)) if size is not None]
    names = [name for name, _, _ in axes]
    if ((len(axes) != 2 and names not in (["data"], ["seq"], ["stage"]))
            or ("stage" in names and names not in (["stage"],
                                                   ["data", "stage"]))):
        raise ValueError(f"init_mesh takes --dp, --sp or --pp alone or two "
                         f"axes (--pp only beside --dp), not {cfg}")
    (row_axis, _, n_rows), (col_axis, _, n_cols) = (axes + [(None, "", 1)])[:2]
    flags = " ".join(f"{flag} {size}" for _, flag, size in axes)
    me, dev, owns, tmpdir = _start(n_rows * n_cols, device, None, None, flags,
                                   "the mesh")
    r, c = divmod(me, n_cols)
    groups = {}
    for col in range(n_cols):
        pg = dist.new_group([row * n_cols + col for row in range(n_rows)])
        if col == c:
            groups[row_axis] = AxisGroup(r, n_rows, dev, pg=pg)
    if col_axis is not None:
        for row in range(n_rows):
            pg = dist.new_group([row * n_cols + col for col in range(n_cols)])
            if row == r:
                groups[col_axis] = AxisGroup(c, n_cols, dev, pg=pg)
    return ProcessMesh(groups.get("data"), groups.get("model"), dev, owns,
                       tmpdir, seq=groups.get("seq"), stage=groups.get("stage"))


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


def _global_rank(axis: AxisGroup, rank: int) -> int:
    """The run's rank of the process at ``rank`` on ``axis``."""
    return rank if axis.pg is None else dist.get_global_rank(axis.pg, rank)


def send(x: torch.Tensor, peer: int, axis: AxisGroup):
    """Send ``x`` to the process at rank ``peer`` of ``axis``, without
    waiting: returns the request, which the caller waits on, and which
    holds ``x`` (a buffer the caller no longer writes) until then."""
    return dist.isend(x.contiguous(), _global_rank(axis, peer), group=axis.pg)


def recv(like: torch.Tensor, peer: int, axis: AxisGroup) -> torch.Tensor:
    """A tensor of ``like``'s shape, type and device received from the
    process at rank ``peer`` of ``axis``."""
    out = torch.empty_like(like, memory_format=torch.contiguous_format)
    dist.recv(out, _global_rank(axis, peer), group=axis.pg)
    return out


def broadcast(x: torch.Tensor, src: int, axis: Optional[AxisGroup]):
    """``x`` of the process at rank ``src`` of ``axis``, on every process of
    the axis (a new tensor)."""
    if axis is None:
        return x
    y = x.contiguous().clone()
    dist.broadcast(y, _global_rank(axis, src), group=axis.pg)
    return y


def all_true(flag: bool, device) -> bool:
    """Whether ``flag`` holds on every process of the run (the default
    group): the ranks of a mesh take the same branch after a check each
    computed on its own."""
    t = torch.tensor([int(flag)], dtype=torch.int32, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    return bool(t.item())
