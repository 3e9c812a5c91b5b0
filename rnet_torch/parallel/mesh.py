"""Process mesh for multi-GPU training and eval: axes ("data", "pairs") on torch.distributed.

Port of ``rnet/parallel/mesh.py``. rnet runs one program over a
``jax.sharding.Mesh`` and GSPMD inserts the collectives; here one process
drives one GPU, as ``torchrun`` launches them, each process holds its own
slice of the batch, and the collectives are written out:

  * ``data``: the global batch of B rows splits over it, rank d holding rows
    [d * B/D, (d + 1) * B/D) (``shard_batch``, ``local_rows``). Gradients,
    the step's loss and accuracy and BatchNorm's batch moments are reduced
    over it; parameters and Adam state stay replicated, equal bit for bit on
    every rank;
  * ``pairs`` (optional): the i-objects of the pairwise g_theta split over it
    (``kernels/pairwise.py::pairwise_core_sharded``, and the ``xla`` and
    ``naive`` impls of ``models/relational.py``). Its members hold the same
    samples and compute the same f_phi, loss and upstream graph.

A spec "data:4,pairs:2" lays the ranks out row-major, as rnet reshapes its
devices: rank r has data index r // 2 and pairs index r % 2. Without a spec
every rank is on ``data``; an axis a spec leaves out has size 1. One process without a process group has no mesh
(``make_mesh`` returns None) and runs the single-device code paths.

The mesh is passed explicitly: ``RN(..., mesh=)`` hands it to the
BatchNorms and the relational layer, and the train step reads it from the
model. rnet's ambient ``pair_sharding`` / ``active_mesh`` context has no
counterpart: a CUDA graph replays what ran under capture, so the mesh
belongs to the model, not to a context around a call.

Random draws: every rank's generator starts from the same seed, every draw
has the global batch's shape and each rank keeps its ``data`` rows
(``local_rows``). So the generators stay in step, pairs members draw the
same masks and augmentation, data ranks draw different rows, and a data:D
run draws what one process at the global batch draws. The pair-dropout
seed is the same on every rank and offset per shard (``Mesh.shard_id``), as
in rnet.

Collectives with a hand-written backward (``torch.autograd.Function``):
  * ``sum_over`` — all-reduce (sum) forward and backward: BatchNorm's global
    moments, which every rank's loss reads;
  * ``reduce_pairs`` — all-reduce forward, identity backward: the pooled g
    sum of a ``pairs`` split, whose members compute the same loss from it;
  * ``replicate_pairs`` — identity forward, all-reduce backward: the inputs
    of a ``pairs`` split, whose gradient each member holds a part of.
Sums run on fp32 tensors, one flat bucket where there are several
(``all_reduce_flat``). The backend is NCCL on CUDA and gloo on the CPU, or
gloo where a caller asks for it: gloo on CUDA tensors stages through host
memory and cannot be captured in a CUDA graph.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

AXES = ("data", "pairs")
# rnet's per-shard offset of the pair-dropout seed (kernels/pairwise.py:646)
SHARD_SEED_STRIDE = 1_000_003


def distributed_init(device="cuda", init_method: Optional[str] = None, world_size: Optional[int] = None,
                     rank: Optional[int] = None, backend: Optional[str] = None) -> bool:
    """Join the process group of a multi-process run (rnet's
    ``distributed_init``).

    Without ``init_method`` it reads torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``), and
    without ``WORLD_SIZE`` there it does nothing: one process. An explicit
    ``init_method`` (``tcp://host:port``, ``file:///path``) takes
    ``world_size`` and ``rank``. Failures raise. The backend is NCCL for a
    CUDA ``device`` and gloo for the CPU unless ``backend`` names one;
    NCCL first binds the process to GPU ``LOCAL_RANK`` (else ``rank``).
    No-op when the group exists already. True when this call created it."""
    if dist.is_initialized():
        return False
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return False
        init_method = "env://"
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank or 0)))
    dist.init_process_group(
        backend, init_method=init_method,
        world_size=-1 if world_size is None else world_size, rank=-1 if rank is None else rank,
    )
    return True


def process_rank() -> int:
    """This process's rank in the process group (0 without one)."""
    return dist.get_rank() if dist.is_initialized() else 0


def parse_spec(spec: str) -> Tuple[Tuple[str, ...], Tuple[int, ...]]:
    """("data:4,pairs:2") -> (("data", "pairs"), (4, 2)); ValueError on an
    axis outside AXES, a repeated axis or a size below 1."""
    names, sizes = [], []
    for part in spec.split(","):
        name, _, size = (s.strip() for s in part.partition(":"))
        if name not in AXES or name in names:
            raise ValueError(f"mesh spec {spec!r}: axes are {AXES}, each at most once; got {name!r}")
        if not size.isdigit() or int(size) < 1:
            raise ValueError(f"mesh spec {spec!r}: axis {name!r} needs a size >= 1, got {size!r}")
        names.append(name)
        sizes.append(int(size))
    return tuple(names), tuple(sizes)


def axis_groups(sizes: Sequence[int], axis: int) -> List[List[int]]:
    """The ranks of each group along ``axis`` of a row-major mesh of
    ``sizes``, every group in the same order on every rank."""
    ranks = torch.arange(math.prod(sizes)).reshape(tuple(sizes)).movedim(axis, -1)
    return ranks.reshape(-1, sizes[axis]).tolist()


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's place in the mesh and the process groups of its axes."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    rank: int
    coords: Tuple[int, ...]
    groups: Tuple[Any, ...]  # this rank's process group along each axis
    device: torch.device
    backend: str

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        return math.prod(self.sizes)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def index(self, axis: str) -> int:
        return dict(zip(self.axis_names, self.coords)).get(axis, 0)

    def group(self, axis: str):
        return self.groups[self.axis_names.index(axis)]

    @property
    def shard_id(self) -> int:
        """rnet's shard id (``pairwise_core_sharded``, :640-646): the sum of
        axis index times stride over the axis names in order; data_idx +
        pairs_idx * D for ("data", "pairs")."""
        sid, stride = 0, 1
        for size, coord in zip(self.sizes, self.coords):
            sid += coord * stride
            stride *= size
        return sid

    def pair_rows(self, n: int, exact: bool = False) -> slice:
        """This rank's i-rows of n objects split over ``pairs`` as
        ``torch.tensor_split`` splits them (the first n % P shards take one
        more); ``exact`` raises unless P divides n, as ``shard_map`` does."""
        P, p = self.size("pairs"), self.index("pairs")
        if exact and n % P:
            raise ValueError(f"{n} object rows do not split evenly over pairs:{P}")
        q, r = divmod(n, P)
        start = p * q + min(p, r)
        return slice(start, start + q + (p < r))


def make_mesh(spec: Optional[str] = None, device="cuda") -> Optional[Mesh]:
    """The mesh of a spec like "data:4" or "data:4,pairs:2" over the
    process group (default: every rank on ``data``), or None for one process
    without a process group. A spec whose size is not the world size
    raises, naming both numbers. Every rank must call it (it creates the
    axes' process groups), and each group runs one all-reduce here, so that
    NCCL's communicators exist before a CUDA graph captures a collective."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    names, sizes = parse_spec(spec) if spec else (("data",), (world,))
    total = math.prod(sizes)
    if total != world:
        raise ValueError(
            f"mesh spec {spec!r} needs {total} processes, the run has {world}: launch it with "
            f"python -m torch.distributed.run --nproc-per-node {total}"
        )
    if not dist.is_initialized():
        return None
    # an axis the spec leaves out has size 1 (and a group of one rank: a
    # collective's group of None would mean every rank)
    missing = tuple(a for a in AXES if a not in names)
    names, sizes = names + missing, sizes + (1,) * len(missing)
    rank = dist.get_rank()
    coords = tuple(int(c) for c in np.unravel_index(rank, sizes))
    groups = []
    for a in range(len(names)):
        mine = None
        for ranks in axis_groups(sizes, a):
            group = dist.new_group(ranks)
            if rank in ranks:
                mine = group
        groups.append(mine)
    mesh = Mesh(names, sizes, rank, coords, tuple(groups), torch.device(device), dist.get_backend())
    for group in mesh.groups:
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=group)
    return mesh


def is_primary(mesh: Optional[Mesh]) -> bool:
    """Rank 0 (or one process): the rank that logs and writes files."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Optional[Mesh]) -> None:
    """Wait for every rank (an all-reduce on the mesh's device)."""
    if mesh is not None:
        dist.all_reduce(torch.zeros(1, device=mesh.device))


def global_batch(B: int, mesh: Optional[Mesh]) -> int:
    """The global batch of which a rank's B rows are a ``data`` slice."""
    return B if mesh is None else B * mesh.size("data")


def local_rows(t: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """This rank's ``data`` rows of a tensor drawn at the global batch."""
    if mesh is None:
        return t
    B = t.shape[0] // mesh.size("data")
    return t[mesh.index("data") * B : (mesh.index("data") + 1) * B]


def shard_batch(batch, mesh: Optional[Mesh], dim: int = 0):
    """This rank's slice along ``data`` of a tensor, or a dict of them,
    that is the same on every rank (a global batch, an epoch's index
    block along ``dim``)."""
    if mesh is None:
        return batch

    def take(x):
        D = mesh.size("data")
        if x.shape[dim] % D:
            raise ValueError(f"a batch of {x.shape[dim]} does not split evenly over data:{D}")
        b = x.shape[dim] // D
        return x.narrow(dim, mesh.index("data") * b, b)

    return {k: take(v) for k, v in batch.items()} if isinstance(batch, dict) else take(batch)


def put_global(x, device) -> torch.Tensor:
    """A host array that is the same on every rank, on ``device``: each
    rank holds all of it, so this is a plain copy (rnet's ``put_global``)."""
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


@torch.no_grad()
def replicate_state(module: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """Broadcast every parameter and buffer of ``module`` from rank 0, in place."""
    if mesh is None:
        return
    for t in module.state_dict().values():
        dist.broadcast(t, src=0)


def fetch_global(x: torch.Tensor, mesh: Optional[Mesh], dim: int = 0) -> torch.Tensor:
    """The ``data`` ranks' tensors of one shape joined along ``dim``, on
    every rank (rnet's allgather of sharded eval outputs)."""
    if mesh is None:
        return x
    parts = [torch.empty_like(x) for _ in range(mesh.size("data"))]
    dist.all_gather(parts, x.contiguous(), group=mesh.group("data"))
    return torch.cat(parts, dim)


def all_reduce_flat(tensors: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Each tensor summed over ``group`` by one fp32 all-reduce of their
    concatenation; returned in each tensor's shape and dtype."""
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    return [p.view(t.shape).to(t.dtype) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over ``group``; its backward an all-reduce of the
    gradient, or the identity."""

    @staticmethod
    def forward(ctx, x, group, grad_sum: bool):
        ctx.group, ctx.grad_sum = group, grad_sum
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        if ctx.grad_sum:
            g = g.clone(memory_format=torch.contiguous_format)
            dist.all_reduce(g, group=ctx.group)
        return g, None, None


def sum_over(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The sum of x over ``axis``, with the gradient summed over it too:
    for a value that every rank's loss reads (BatchNorm's global moments)."""
    return _SumOver.apply(x, mesh.group(axis), True)


def reduce_pairs(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of the ``pairs`` members' partial x; its gradient passes
    through unchanged, since every member computes the same loss from the
    sum."""
    return _SumOver.apply(x, mesh.group("pairs"), False)


class _ReplicatePairs(torch.autograd.Function):
    @staticmethod
    def forward(ctx, group, *xs):
        ctx.group = group
        ctx.set_materialize_grads(True)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        return (None, *all_reduce_flat(gs, ctx.group))


def replicate_pairs(tensors: Sequence[torch.Tensor], mesh: Mesh) -> Tuple[torch.Tensor, ...]:
    """The tensors unchanged, with their gradients summed over ``pairs``
    (one all-reduce): the inputs of a ``pairs`` split, of which each member
    uses a part, so that every member ends with the full gradient."""
    return _ReplicatePairs.apply(mesh.group("pairs"), *tensors)
