"""The mesh of ranks and the placement of a leaf on it.

Counterpart of the JAX package's `parallel/mesh.py`. There a mesh is a
grid of devices that one or more processes share, and GSPMD inserts
the collectives. Here one rank is one process on one device
(`parallel/distributed.py`), so the mesh is a grid of the world's
ranks, laid out `(pipe, data, seq, expert, model)` with `model`
innermost, as JAX lays out its devices: rank `r` sits at data
coordinate `r // model` and model coordinate `r % model`. Each axis
larger than 1 has one process group (`torch.distributed.new_group`)
per line of ranks along it, and the learner (`parallel/learner.py`)
calls the collectives explicitly:

- `data`: each rank holds its own rows of the batch; gradients are
  all-reduced across the axis.
- `model`: each rank stores its slice of every large kernel and of its
  optimizer moments, and all-gathers the whole kernel before the
  forward (the FSDP pattern; the numbers are the union batch's, as
  GSPMD's are).
- `seq`, `pipe` and `expert` above 1 are ROADMAP item 13c.

Only `all_reduce` (sum, or max for JAX's `pmax`), `broadcast` and
`all_gather` are used: the collectives gloo carries for CUDA tensors
(two ranks on one GPU run gloo). The class is the port's own rather than
`torch.distributed.device_mesh.DeviceMesh`, whose `init_device_mesh`
maps one rank to one device of its own.

A placement (`Placement`) is the port's `NamedSharding`: the mesh and a
spec naming, per dimension of the port's tensor, the axis it is split
over or None. `place_local_batch` puts this rank's rows on its device;
in a world of one that is the whole batch, placed as it would be
without a mesh. JAX's `pcast_varying` has no counterpart: it types
`shard_map` carries in JAX's type system, and nothing here traces.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist

from distributed_reinforcement_learning_tpu_torch.data.fifo import tree_map
from distributed_reinforcement_learning_tpu_torch.parallel import distributed

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
SEQ_AXIS = "seq"
EXPERT_AXIS = "expert"
MODEL_AXIS = "model"
AXES = (PIPE_AXIS, DATA_AXIS, SEQ_AXIS, EXPERT_AXIS, MODEL_AXIS)

# The backend op of each reduction; a mean is a sum divided after.
_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}

ITEM_13C = ("sequence, pipeline and expert parallelism are ROADMAP item 13c, "
            "which is not ported")


def mesh_shape(n_devices: int, model_parallel: int = 1, seq_parallel: int = 1,
               pipe_parallel: int = 1, expert_parallel: int = 1) -> dict[str, int]:
    """The axis sizes of a `(pipe, data, seq, expert, model)` mesh over
    `n_devices` ranks; raises ValueError when the inner sizes do not
    divide them, and names item 13c for seq, pipe or expert above 1."""
    inner = model_parallel * seq_parallel * expert_parallel
    if n_devices % (inner * pipe_parallel) != 0:
        raise ValueError(f"{n_devices} devices not divisible by pipe*seq*expert*model="
                         f"{inner * pipe_parallel}")
    for name, size in (("seq_parallel", seq_parallel), ("pipe_parallel", pipe_parallel),
                       ("expert_parallel", expert_parallel)):
        if size > 1:
            raise ValueError(f"{name}={size}: {ITEM_13C}")
    return {PIPE_AXIS: pipe_parallel, DATA_AXIS: n_devices // (inner * pipe_parallel),
            SEQ_AXIS: seq_parallel, EXPERT_AXIS: expert_parallel, MODEL_AXIS: model_parallel}


class RankMesh:
    """A `(pipe, data, seq, expert, model)` grid of the world's ranks.

    `shape` maps each axis to its size (JAX's `mesh.shape`), `coords`
    this rank's coordinate on each, `device` this rank's device. The
    collectives act along one axis and are the identity on an axis of
    size 1; each counts the bytes it hands the backend (`bytes_moved`).
    """

    def __init__(self, shape: dict[str, int], device: torch.device):
        self.shape = dict(shape)
        self.device = device
        self.rank, self.world = distributed.process_info()
        sizes = [self.shape[a] for a in AXES]
        strides, acc = {}, 1
        for axis, size in zip(reversed(AXES), reversed(sizes)):
            strides[axis] = acc
            acc *= size
        self._strides = strides
        self.coords = {a: (self.rank // strides[a]) % self.shape[a] for a in AXES}
        self.bytes_moved = 0
        self._groups: dict[str, Any] = {}
        for axis in AXES:
            if self.shape[axis] > 1:
                self._groups[axis] = self._new_groups(axis)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def ranks(self, axis: str, rank: int | None = None) -> list[int]:
        """The ranks on `rank`'s line along `axis`, in coordinate order."""
        rank = self.rank if rank is None else rank
        base = rank - self.coords_of(rank)[axis] * self._strides[axis]
        return [base + i * self._strides[axis] for i in range(self.shape[axis])]

    def coords_of(self, rank: int) -> dict[str, int]:
        return {a: (rank // self._strides[a]) % self.shape[a] for a in AXES}

    def _new_groups(self, axis: str):
        """One group per line along `axis`, made by every rank in the same
        order (`new_group` is collective); -> this rank's."""
        mine, seen = None, set()
        for r in range(self.world):
            line = tuple(self.ranks(axis, r))
            if line in seen:
                continue
            seen.add(line)
            group = dist.new_group(list(line))
            if self.rank in line:
                mine = group
        return mine

    # -- collectives along one axis ---------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Sum, mean or maximum (`op` "sum", "mean", "max": JAX's `psum`,
        `pmean`, `pmax`) of `t` over the axis, in place; -> `t`."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduction {op!r}")
        n = self.shape[axis]
        if n == 1:
            return t
        self.bytes_moved += t.numel() * t.element_size()
        dist.all_reduce(t, op=_REDUCE_OPS[op], group=self._groups[axis])
        if op == "mean":
            t.div_(n)
        return t

    def all_gather(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """The axis's tensors concatenated along `dim` in coordinate order."""
        n = self.shape[axis]
        if n == 1:
            return t
        t = t.contiguous()
        self.bytes_moved += t.numel() * t.element_size()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._groups[axis])
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`t` from global rank `src` to every rank of the world, in place.
        Runs whenever the world is joined, a world of one included."""
        if distributed.is_initialized():
            self.bytes_moved += t.numel() * t.element_size()
            dist.broadcast(t, src=src)
        return t

    def __repr__(self) -> str:
        return f"RankMesh({self.shape}, rank {self.rank}/{self.world} on {self.device})"


def make_mesh(n_devices: int | None = None, model_parallel: int = 1, seq_parallel: int = 1,
              pipe_parallel: int = 1, expert_parallel: int = 1,
              device: torch.device | str | None = None) -> RankMesh:
    """A `(pipe, data, seq, expert, model)` mesh over the world's ranks
    (`n_devices` of them; None: all). Without a joined world the world is
    this process alone, on `device` (the CPU unless named). Every rank
    of the world calls it, in the same order as its other meshes."""
    rank, world = distributed.process_info()
    n = world if n_devices is None else n_devices
    if n > world:
        raise ValueError(f"requested {n} devices but the world has {world} rank(s); start "
                         f"{n} processes (DRL_NUM_PROCESSES) to run a mesh of {n}")
    if n < world:
        raise ValueError(f"a mesh of {n} over a world of {world} ranks: every rank of the "
                         f"world is one device of the mesh")
    shape = mesh_shape(n, model_parallel, seq_parallel, pipe_parallel, expert_parallel)
    dev = distributed.device() or torch.device("cpu" if device is None else device)
    return RankMesh(shape, dev)


class Placement:
    """Where a leaf lives on a mesh: `spec[i]` names the axis dimension
    `i` of the port's tensor is split over, or None (JAX's
    `NamedSharding(mesh, PartitionSpec(*spec))`); `()` replicates."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh: RankMesh, spec: tuple = ()):
        self.mesh = mesh
        self.spec = tuple(spec)

    def dim(self, axis: str) -> int | None:
        """The dimension split over `axis`, or None."""
        return self.spec.index(axis) if axis in self.spec else None

    def __repr__(self) -> str:
        return f"Placement({self.spec})"


def replicated(mesh: RankMesh) -> Placement:
    return Placement(mesh, ())


def data_sharding(mesh: RankMesh) -> Placement:
    """The leading (batch) dimension over the `data` axis."""
    return Placement(mesh, (DATA_AXIS,))


def model_kernel_sharding(mesh: RankMesh, ndim: int, dim: int = -1) -> Placement:
    """A kernel split over the `model` axis along `dim` of the port's
    tensor: the dimension that holds the flax kernel's last (output
    feature) one (`parallel/learner.py:model_dim`)."""
    spec = [None] * ndim
    spec[dim] = MODEL_AXIS
    return Placement(mesh, tuple(spec))


def place_local_batch(tree: Any, sharding: Placement | None, device=None) -> Any:
    """This rank's host rows -> tensors on its device, the local shard of
    the global batch (`global batch / data` rows a rank over a data
    split). Without a placement the tree goes to `device` (the CPU by
    default). Tensor fields keep their dtype."""
    dev = sharding.mesh.device if sharding is not None else torch.device(device or "cpu")
    return map_leaves(lambda x: torch.as_tensor(x).to(dev), tree)


def map_leaves(fn, tree: Any) -> Any:
    """`data/fifo.tree_map` that also walks a plain tuple, such as
    `(batch, is_weight)`."""
    if isinstance(tree, tuple) and not hasattr(tree, "_fields"):
        return tuple(map_leaves(fn, x) for x in tree)
    return tree_map(fn, tree)

