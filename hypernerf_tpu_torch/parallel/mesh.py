"""The data-parallel context and its collectives (port of
``hypernerf_tpu/parallel/mesh.py``).

The JAX package's one parallelism is a 1-D ``('data',)`` mesh: each device
takes its slice of the ray batch, the parameters are replicated and the
gradients ``lax.pmean``-ed. Here a ``DataParallel`` context (world size,
rank, device) stands for the mesh, one rank a process on one
card, and these functions for its placements and its ``pmean``.

Every collective is built from ``all_reduce`` and ``broadcast`` alone. Gloo
has no ``all_gather`` and no ``reduce_scatter`` on CUDA tensors, and NCCL
refuses two ranks on one device, so only gloo can put two ranks on one
card; with these two collectives one code path runs over NCCL, over gloo on
the CPU and over gloo on a shared card. Each call moves one flat buffer per
dtype, not one per tensor.

Collectives write tensors in place without bumping their version counters,
and the level kernels key their packed bf16 weights on the parameters'
versions (``kernels/common.py``): a parameter written by a collective and
not bumped would leave every rank but the writer running the old weights.
``replicate`` therefore writes the parameters with ``copy_``, which bumps
them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import torch

from hypernerf_tpu_torch.parallel.distributed import launch_env, rank_device


@dataclasses.dataclass(frozen=True)
class DataParallel:
    """``world_size`` ranks of the default process group, this process
    ``rank`` on ``device``. ``joined``: a process group exists, so the
    collectives run, even in a world of one; without one every collective
    is the identity."""
    world_size: int = 1
    rank: int = 0
    device: torch.device = torch.device('cpu')
    joined: bool = False

    @property
    def is_primary(self) -> bool:
        return self.rank == 0


def create_mesh(num_devices: Optional[int] = None) -> DataParallel:
    """The context of this process: its launch's ranks where a process group
    is initialized (``distributed.maybe_initialize_distributed``), else a
    world of one; its device is the rank's card (``LOCAL_RANK``), or the
    CPU under ``HYPERNERF_PLATFORM=cpu``. ``num_devices``, when given, must
    be the world size."""
    import torch.distributed as dist
    if dist.is_initialized():
        env = launch_env()
        ctx = DataParallel(dist.get_world_size(), dist.get_rank(),
                           rank_device(env['local_rank'] if env else None),
                           True)
    else:
        ctx = DataParallel(1, 0, rank_device())
    if num_devices is not None and num_devices != ctx.world_size:
        raise ValueError(f'{num_devices} devices asked for in a launch of '
                         f'{ctx.world_size} rank(s)')
    return ctx


def shard_batch(mesh: DataParallel, tree):
    """Rank r's rows ``r*B/N:(r+1)*B/N`` of every tensor of ``tree`` (a
    tensor, or a dict of tensors with B rows each): the JAX package's
    ``P('data')`` order. B must be divisible by the world size N."""
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v) for k, v in tree.items()}
    rows, n = tree.shape[0], mesh.world_size
    if rows % n:
        raise ValueError(f'a batch of {rows} rows must be divisible by the '
                         f'number of ranks {n}')
    per = rows // n
    return tree[mesh.rank * per:(mesh.rank + 1) * per]


def _by_dtype(tensors: Sequence[torch.Tensor]) -> Dict[torch.dtype, List]:
    groups: Dict[torch.dtype, List] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _flat(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tensors])


def _unflat_into(flat: torch.Tensor, tensors: Sequence[torch.Tensor]):
    at = 0
    for t in tensors:
        t.copy_(flat[at:at + t.numel()].view_as(t))
        at += t.numel()


@torch.no_grad()
def replicate(mesh: DataParallel, module: torch.nn.Module):
    """Every parameter and buffer of ``module`` from rank 0, on every rank
    (the JAX package's ``replicate``): one broadcast of a flat buffer per
    dtype, written back with ``copy_``, which bumps every parameter's
    version (see the module docstring). Returns ``module``."""
    if not mesh.joined:
        return module
    import torch.distributed as dist
    tensors = list(module.parameters()) + list(module.buffers())
    for idx in _by_dtype(tensors).values():
        group = [tensors[i] for i in idx]
        flat = _flat(group)
        dist.broadcast(flat, src=0)
        _unflat_into(flat, group)
    return module


@torch.no_grad()
def all_reduce_mean(mesh: DataParallel, tensors: Sequence[torch.Tensor]):
    """Replace each of ``tensors`` by its mean over the ranks, in place:
    one ``all_reduce`` (sum) of a flat buffer per dtype, then a division by
    the world size (the JAX package's ``lax.pmean``). Every rank must pass
    tensors of the same shapes and dtypes in the same order."""
    if not mesh.joined:
        return
    import torch.distributed as dist
    for idx in _by_dtype(tensors).values():
        group = [tensors[i] for i in idx]
        flat = _flat(group)
        dist.all_reduce(flat)
        flat.div_(mesh.world_size)
        _unflat_into(flat, group)


@torch.no_grad()
def gather_rows(mesh: DataParallel, tensors: Sequence[torch.Tensor]
                ) -> List[torch.Tensor]:
    """Every rank's ``tensors`` (the same shapes on every rank) joined
    along dim 0 in rank order, on every rank: rank r's rows of each output
    are its own tensor's. One broadcast from each rank of a flat buffer per
    dtype (gloo has no all_gather of CUDA tensors)."""
    if not mesh.joined or mesh.world_size == 1:
        return list(tensors)
    import torch.distributed as dist
    n = mesh.world_size
    outs = [t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
            for t in tensors]
    for idx in _by_dtype(tensors).values():
        group = [tensors[i] for i in idx]
        total = sum(t.numel() for t in group)
        for r in range(n):
            flat = (_flat(group) if r == mesh.rank else
                    group[0].new_empty(total))
            dist.broadcast(flat, src=r)
            at = 0
            for i, t in zip(idx, group):
                rows = t.shape[0]
                outs[i][r * rows:(r + 1) * rows].copy_(
                    flat[at:at + t.numel()].view_as(t))
                at += t.numel()
    return outs


def barrier(mesh: DataParallel) -> None:
    """Wait until every rank is here (an ``all_reduce`` of one element on
    the rank's device, which every backend runs on every device)."""
    if mesh.joined:
        import torch.distributed as dist
        dist.all_reduce(torch.zeros(1, device=mesh.device))
