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
- `seq`: each rank holds `T / seq` steps of every sequence of its rows;
  the attention's keys and values travel round the ring
  (`parallel/sequence.py`).
- `pipe`: each rank holds `num_layers / pipe` layers and runs them on
  the microbatches the rank before it hands on (`parallel/pipeline.py`).
- `expert`: each rank holds `E / expert` experts and runs them on the
  tokens routed to them (`ops/moe.py`).

The collectives are `all_reduce` (sum, or max for JAX's `pmax`),
`broadcast`, `all_gather`, and two for JAX's `lax.ppermute` and
`lax.all_to_all`: `shift` (each rank's tensor to the rank `offset`
further along an axis) and `all_to_all`, both one `all_to_all_single`
with split sizes, which gloo carries for CPU and CUDA tensors alike
(two ranks on one GPU run gloo). The class is the port's own rather than
`torch.distributed.device_mesh.DeviceMesh`, whose `init_device_mesh`
maps one rank to one device of its own.

Differentiable forms (`shift`, `all_to_all`, `enter`, `psum_invariant`,
`gather_invariant`, `gather_varying`) are
`torch.autograd.Function`s whose backward is the forward's transpose
under the port's two conventions: along `data` each rank's loss is its
share of the union's (a cotangent is partial, and the transpose of a
sum or a gather sums); along `seq`, `pipe` and `expert` the loss is the
same on every rank (a cotangent outside a sharded region is the whole
one, so the transpose of a gather out of the region takes this rank's
slice, that of a sum out of it is the identity, and an input that enters
it sums its cotangent over the axis, JAX's `pvary`).

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


def mesh_shape(n_devices: int, model_parallel: int = 1, seq_parallel: int = 1,
               pipe_parallel: int = 1, expert_parallel: int = 1) -> dict[str, int]:
    """The axis sizes of a `(pipe, data, seq, expert, model)` mesh over
    `n_devices` ranks; raises ValueError when the inner sizes do not
    divide them."""
    inner = model_parallel * seq_parallel * expert_parallel
    if n_devices % (inner * pipe_parallel) != 0:
        raise ValueError(f"{n_devices} devices not divisible by pipe*seq*expert*model="
                         f"{inner * pipe_parallel}")
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
        self.bytes_by: dict[str, int] = {}
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

    def _count(self, kind: str, axis: str, t: torch.Tensor) -> None:
        n = t.numel() * t.element_size()
        self.bytes_moved += n
        key = f"{kind}/{axis}"
        self.bytes_by[key] = self.bytes_by.get(key, 0) + n

    # -- collectives along one axis ---------------------------------------
    def all_reduce(self, t: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
        """Sum, mean or maximum (`op` "sum", "mean", "max": JAX's `psum`,
        `pmean`, `pmax`) of `t` over the axis, in place; -> `t`."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"unknown reduction {op!r}")
        n = self.shape[axis]
        if n == 1:
            return t
        self._count("all_reduce", axis, t)
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
        self._count("all_gather", axis, t)
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=self._groups[axis])
        return torch.cat(parts, dim=dim)

    def shift(self, t: torch.Tensor, axis: str, offset: int = 1,
              cyclic: bool = True) -> torch.Tensor:
        """JAX's `lax.ppermute` by a fixed offset: the tensor of the rank at
        coordinate `i - offset` along the axis (modulo its size when
        `cyclic`; zeros where no rank sends, as `ppermute` fills them)."""
        n = self.shape[axis]
        if n == 1:
            return t if cyclic else torch.zeros_like(t)
        i = self.coords[axis]
        dst, src = i + offset, i - offset
        if cyclic:
            dst, src = dst % n, src % n
        flat = t.contiguous().reshape(-1)
        sends = 0 <= dst < n
        ins = [flat.numel() if (sends and j == dst) else 0 for j in range(n)]
        outs = [flat.numel() if j == src else 0 for j in range(n)]
        out = torch.empty(sum(outs), dtype=t.dtype, device=t.device)
        if sends:
            self._count("shift", axis, flat)
        dist.all_to_all_single(out, flat if sends else flat[:0], output_split_sizes=outs,
                               input_split_sizes=ins, group=self._groups[axis])
        return out.view_as(t) if 0 <= src < n else torch.zeros_like(t)

    def all_to_all(self, t: torch.Tensor, axis: str, split_dim: int,
                   concat_dim: int) -> torch.Tensor:
        """JAX's tiled `lax.all_to_all`: `t` cut into `n` equal parts along
        `split_dim`, part j sent to the rank at coordinate j, and the parts
        received concatenated along `concat_dim` in coordinate order."""
        n = self.shape[axis]
        if n == 1:
            return t
        s, c = split_dim % t.dim(), concat_dim % t.dim()
        if t.shape[s] % n:
            raise ValueError(f"all_to_all: dim {s} of {tuple(t.shape)} not divisible by "
                             f"the {axis} axis ({n})")
        parts = t.unflatten(s, (n, t.shape[s] // n)).movedim(s, 0).contiguous()
        self._count("all_to_all", axis, parts)
        out = torch.empty_like(parts)
        dist.all_to_all_single(out, parts, group=self._groups[axis])
        return out.movedim(0, c).flatten(c, c + 1)

    def broadcast_axis(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """`t` from the rank at coordinate 0 of this rank's line along
        `axis` to the line, in place; -> `t`."""
        if self.shape[axis] == 1:
            return t
        self._count("broadcast", axis, t)
        dist.broadcast(t, src=self.ranks(axis)[0], group=self._groups[axis])
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """`t` from global rank `src` to every rank of the world, in place.
        Runs whenever the world is joined, a world of one included."""
        if distributed.is_initialized():
            self._count("broadcast", "world", t)
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



# -- differentiable collectives ----------------------------------------------
# Each takes (mesh, x, axis, ...) and is the identity on an axis of size 1.
# Every rank of the axis must call them in the same order, and autograd
# then runs their backward collectives in the same order: a rank whose
# branch leaves a collective's output unused would skip its backward and
# leave the others waiting, so callers keep the graph the same on every
# rank (`torch.where` on a rank-dependent mask, not a Python branch).

class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, offset, cyclic):
        ctx.args = (mesh, axis, offset, cyclic)
        return mesh.shift(x, axis, offset, cyclic)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, offset, cyclic = ctx.args
        return mesh.shift(g, axis, -offset, cyclic), None, None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.args = (mesh, axis, split_dim, concat_dim)
        return mesh.all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, split_dim, concat_dim = ctx.args
        return mesh.all_to_all(g, axis, concat_dim, split_dim), None, None, None, None


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.args = (mesh, axis)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        mesh, axis = ctx.args
        return mesh.all_reduce(g.clone(), axis), None, None


class _PsumInvariant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return mesh.all_reduce(x.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, dim, varying):
        ctx.args = (mesh, axis, dim, varying, x.shape[dim])
        return mesh.all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, dim, varying, n = ctx.args
        if varying:
            g = mesh.all_reduce(g.contiguous().clone(), axis)
        return g.narrow(dim, mesh.coords[axis] * n, n), None, None, None, None


def shift(mesh: RankMesh, x: torch.Tensor, axis: str, offset: int = 1,
          cyclic: bool = True) -> torch.Tensor:
    """Differentiable `RankMesh.shift`; its backward shifts the cotangent
    back by `-offset`."""
    return _Shift.apply(x, mesh, axis, offset, cyclic)


def all_to_all(mesh: RankMesh, x: torch.Tensor, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """Differentiable `RankMesh.all_to_all`; its backward is the inverse
    all-to-all (split and concat dims swapped)."""
    return _AllToAll.apply(x, mesh, axis, split_dim, concat_dim)


def enter(mesh: RankMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """A value the same on every rank of `axis` entering per-rank work
    (JAX's `pvary`): the identity, whose backward sums the cotangent over
    the axis."""
    return x if mesh.shape[axis] == 1 else _Enter.apply(x, mesh, axis)


def psum_invariant(mesh: RankMesh, x: torch.Tensor, axis: str) -> torch.Tensor:
    """Per-rank parts summed into the value the same on every rank after
    it (JAX's `psum`): its backward hands each rank the cotangent as it
    is."""
    return x if mesh.shape[axis] == 1 else _PsumInvariant.apply(x, mesh, axis)


def gather_invariant(mesh: RankMesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The axis's parts concatenated along `dim`, out of a sharded region
    into work the same on every rank: the backward takes this rank's
    slice of the cotangent."""
    return x if mesh.shape[axis] == 1 else _Gather.apply(x, mesh, axis, dim, False)


def gather_varying(mesh: RankMesh, x: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The parts concatenated along `dim` where the cotangents are partial
    (along `data`, or inside a sharded region): the backward sums the
    cotangent over the axis and takes this rank's slice."""
    return x if mesh.shape[axis] == 1 else _Gather.apply(x, mesh, axis, dim, True)
