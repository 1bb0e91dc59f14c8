"""Process groups and batch shares for data parallelism (port of the JAX
package's ``parallel/mesh.py``).

The JAX package runs one program over a device mesh: ``shard_map`` hands
each device its block of the batch and ``pmean`` averages the gradients and
logs over the mesh axes. Here each rank is one process with one device, as
under ``torchrun`` (or the reference's ``accelerate``): DDP (or, for the
DiT's ``spmd="fsdp"``, FSDP2 and tensor parallelism over
:meth:`Mesh.device_mesh`, ``parallel/fsdp.py``) handles the gradients, and
the trainers reduce their logs and eval statistics with the collectives of
:class:`Mesh`.

* Axes: ``"data"`` (each data index reads its own items: ``data/loader.py``'s
  ``shard_for_host``), ``"view"`` (the ranks of one data index read the
  same items and each renders its own block of the supervised views,
  ``VIEW_SHARDED_KEYS``) and ``"model"`` (the ranks of one data index read
  the same items, share one generator seed, and each holds its share of the
  DiT blocks' heads and FFN width). 'view' and 'model' never appear
  together, as in the JAX package. Ranks are laid out data-major, as the
  JAX package reshapes its device list: on (2, 2), ranks 0-1 are data 0.
* ``batch_sharding`` and ``replicate`` have no counterpart. They name a
  placement of one global array across devices; under DDP each rank holds
  whole tensors of its own. A replicated array is a tensor every rank holds
  (DDP broadcasts rank 0's weights when it wraps a module), a batch-sharded
  one the share :func:`shard_batch` gives this rank.
"""

from __future__ import annotations

import collections
import dataclasses
import itertools
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from sigman_release_torch.device import resolve_device

AXES = ("data", "view", "model")

# batch keys whose second dim is the render-view axis, shardable over a
# 'view' axis: each view rank rasterizes its views of every item against
# the same Gaussians, and the photometric losses decompose over views
VIEW_SHARDED_KEYS = (
    "cam_view", "cam_view_proj", "cam_pos", "images_output", "masks_output",
)


def initialize_multihost(device="cuda", *, backend: Optional[str] = None,
                         init_method: Optional[str] = None,
                         rank: Optional[int] = None,
                         world_size: Optional[int] = None) -> torch.device:
    """Join the process group that ``torchrun``'s environment describes
    (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` /
    ``MASTER_PORT``), or the one the arguments name, and return this
    process's device: ``cuda:LOCAL_RANK`` for a bare ``"cuda"``. The backend
    is NCCL on CUDA and gloo on the CPU unless ``backend`` names one. With no
    ``WORLD_SIZE``, a world of 1, or a group already joined it joins
    nothing."""
    env = os.environ
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", 0)))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    if world <= 1 or dist.is_initialized():
        return dev
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method or "env://", world_size=world,
        rank=int(env["RANK"]) if rank is None else rank)
    return dev


def is_rank0() -> bool:
    """Whether this process is rank 0 of its process group (or alone): the
    one that prints and writes files."""
    return not dist.is_initialized() or dist.get_rank() == 0


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in a ('data'[, 'view' | 'model']) layout of the
    world.

    ``shape`` and ``axis_names`` as in the JAX package's mesh, ``coords``
    this rank's index on each axis, ``groups`` one process group per axis
    (the ranks that differ only on it; None without a process group).
    ``distributed`` is whether a process group exists: the trainers wrap
    their modules in DDP exactly then, a world of 1 included. The
    collectives below run over every rank and do nothing without a group."""

    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Tuple[int, ...]
    groups: Tuple[Optional[object], ...]
    rank: int = 0
    world: int = 1
    distributed: bool = False
    comm_device: torch.device = torch.device("cpu")

    def size(self, axis: str) -> int:
        return (self.shape[self.axis_names.index(axis)]
                if axis in self.axis_names else 1)

    def index(self, axis: str) -> int:
        return (self.coords[self.axis_names.index(axis)]
                if axis in self.axis_names else 0)

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]

    @property
    def data_index(self) -> int:
        return self.index("data")

    @property
    def data_size(self) -> int:
        return self.size("data")

    @property
    def view_index(self) -> int:
        return self.index("view")

    @property
    def view_size(self) -> int:
        return self.size("view")

    @property
    def model_index(self) -> int:
        return self.index("model")

    @property
    def model_size(self) -> int:
        return self.size("model")

    def device_mesh(self, device_type: str):
        """The ``DeviceMesh`` of this layout over the axis groups that
        :func:`make_mesh` created (dim names the mesh's axes: ``("data",)``
        or ``("data", "model")``), for FSDP2 and tensor parallelism. Needs a
        process group and no 'view' axis."""
        from torch.distributed.device_mesh import DeviceMesh

        if not self.distributed or "view" in self.axis_names:
            raise ValueError(f"device_mesh: mesh {self.axis_names} "
                             f"(distributed: {self.distributed})")
        ranks = np.arange(self.world).reshape(self.shape)
        if len(self.axis_names) == 1:
            return DeviceMesh.from_group(self.groups[0], device_type,
                                         mesh_dim_names=self.axis_names)
        return DeviceMesh.from_group(list(self.groups), device_type,
                                     mesh=ranks,
                                     mesh_dim_names=self.axis_names)

    # ---- collectives over every rank (no-ops without a process group)

    def all_reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced in place over every rank by ``"sum"``, ``"max"``
        or ``"min"``."""
        if self.distributed:
            ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
                   "min": dist.ReduceOp.MIN}
            dist.all_reduce(t, op=ops[op])
        return t

    def mean(self, logs: Dict[str, torch.Tensor],
             weight: float = 1.0) -> Dict[str, torch.Tensor]:
        """Each scalar log averaged over every rank, weighting rank r by
        ``weight`` (its item count; 1: the plain mean ``pmean`` takes), in
        one collective."""
        if not self.distributed or not logs:
            return logs
        names = list(logs)
        stats = torch.stack([logs[n].detach().float().reshape(()) * weight
                             for n in names]
                            + [torch.tensor(float(weight),
                                            device=logs[names[0]].device)])
        stats = self.all_reduce_(stats.to(self.comm_device))
        stats = (stats[:-1] / stats[-1]).to(logs[names[0]].device)
        return dict(zip(names, stats.unbind()))

    def min_int(self, n: int) -> int:
        """The least of ``n`` over every rank (the steps all ranks can
        take)."""
        t = torch.tensor([int(n)], dtype=torch.int64, device=self.comm_device)
        return int(self.all_reduce_(t, "min").item())

    def max_int(self, n: int) -> int:
        t = torch.tensor([int(n)], dtype=torch.int64, device=self.comm_device)
        return int(self.all_reduce_(t, "max").item())

    def gather(self, obj) -> list:
        """Every rank's ``obj`` (picklable), indexed by rank."""
        if not self.distributed:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj, src: int = 0):
        """Rank ``src``'s ``obj`` (picklable) on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=src)
        return box[0]

    def barrier(self):
        if self.distributed:
            dist.barrier()


def make_mesh(shape: Sequence[int] = (-1,),
              axes: Sequence[str] = ("data",)) -> Mesh:
    """The layout of this process's world over ``axes`` (``"data"`` first,
    then optionally ``"view"`` or ``"model"``); -1 takes what the other axes
    leave of the world size. Ranks are laid out data-major (rank =
    data_index x second axis size + its index). Every rank must call it: it
    creates one process group per line of each axis."""
    axes = tuple(axes)
    unknown = [a for a in axes if a not in AXES]
    if (unknown or axes[0] != "data" or len(set(axes)) != len(axes)
            or {"view", "model"} <= set(axes)):
        raise ValueError(f"mesh axes {axes}: 'data' first, then 'view' or "
                         f"'model', each once")
    shape = [int(s) for s in shape]
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} does not match axes {axes}")
    distributed = dist.is_initialized()
    world = dist.get_world_size() if distributed else 1
    rank = dist.get_rank() if distributed else 0
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = world // max(known, 1)
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} does not cover the world of "
                         f"{world} rank(s)")
    coords = tuple(int(c) for c in np.unravel_index(rank, shape))
    groups = [None] * len(axes)
    comm_device = torch.device("cpu")
    if distributed:
        ranks = np.arange(world).reshape(shape)
        for i in range(len(axes)):
            for line in np.moveaxis(ranks, i, -1).reshape(-1, shape[i]):
                group = dist.new_group(line.tolist())   # on every rank
                if rank in line:
                    groups[i] = group
        if dist.get_backend() == "nccl":
            comm_device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(tuple(shape), axes, coords, tuple(groups), rank, world,
                distributed, comm_device)


def rank_seed(seed: int, data_index: int = 0, step: int = 0) -> int:
    """A generator seed for (seed, data index, step): ``seed`` itself at
    data index 0 and step 0, so that one process draws as it always has;
    else 64 bits of a ``numpy.random.SeedSequence`` of the three. The view
    (and model) ranks of one data index share it, so they draw the same
    posterior noise and dropout masks."""
    if data_index == 0 and step == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(data_index), int(step)])
               .generate_state(1, np.uint64)[0])


def batch_spec(key: str, mesh: Mesh, axis: str = "data") -> Tuple[str, ...]:
    """The axes one batch entry's leading dims are split over, as the JAX
    package's ``PartitionSpec``."""
    if "view" in mesh.axis_names and key in VIEW_SHARDED_KEYS:
        return (axis, "view")
    return (axis,)


def batch_specs(batch, mesh: Mesh, axis: str = "data"):
    return {k: batch_spec(k, mesh, axis) for k in batch}


def shard_batch(batch, mesh: Mesh, device, pin: bool = False
                ) -> Dict[str, torch.Tensor]:
    """This rank's share of a batch its loader read, as tensors on
    ``device``: each key of ``VIEW_SHARDED_KEYS`` sliced to this rank's
    contiguous block of views along dim 1 (the data split happened when the
    items were sharded). Non-array entries (item ids) are dropped. ``pin``
    stages each host share in pinned memory and copies it without
    blocking."""
    n, v = mesh.view_size, mesh.view_index
    out = {}
    for k, x in batch.items():
        if not isinstance(x, (np.ndarray, torch.Tensor)):
            continue
        t = torch.as_tensor(x)
        if n > 1 and k in VIEW_SHARDED_KEYS:
            if t.shape[1] % n:
                raise ValueError(f"{k}: {t.shape[1]} views do not split over "
                                 f"a view axis of {n}")
            w = t.shape[1] // n
            t = t[:, v * w:(v + 1) * w]
        if pin and t.device.type == "cpu":
            t = t.contiguous().pin_memory()
        out[k] = t.to(device, non_blocking=pin)
    return out


def prefetch_to_device(iterable, mesh: Mesh, device, size: int = 2):
    """Iterate this rank's device batches (:func:`shard_batch`), ``size``
    batches ahead. On CUDA each share is staged in pinned memory and copied
    on a side stream without blocking; the consumer's stream waits for that
    copy before it uses the batch."""
    device = torch.device(device)
    it = iter(iterable)
    if device.type != "cuda":
        for b in it:
            yield shard_batch(b, mesh, device)
        return
    stream = torch.cuda.Stream(device)
    q: "collections.deque" = collections.deque()

    def put(b):
        with torch.cuda.stream(stream):
            out = shard_batch(b, mesh, device, pin=True)
            done = torch.cuda.Event()
            done.record(stream)
        q.append((out, done))

    for b in itertools.islice(it, size):
        put(b)
    while q:
        out, done = q.popleft()
        main = torch.cuda.current_stream(device)
        main.wait_event(done)
        for t in out.values():
            t.record_stream(main)
        for b in itertools.islice(it, 1):
            put(b)
        yield out
