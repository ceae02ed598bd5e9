"""The process group of a data-parallel launch (port of
``hypernerf_tpu/parallel/distributed.py``).

In the JAX package a process is a host that drives several devices; here a
process is one rank on one GPU (or on the CPU). A process finds its launch
in the environment:

* ``HYPERNERF_COORDINATOR`` (address:port where rank 0 listens),
  ``HYPERNERF_NUM_PROCESSES`` (the world size, default 1) and
  ``HYPERNERF_PROCESS_ID`` (this process's rank, default 0): the JAX
  package's variables, with a process now a rank;
* else torchrun's ``RANK`` and ``WORLD_SIZE`` (and its ``MASTER_ADDR`` /
  ``MASTER_PORT``).

``LOCAL_RANK`` picks the rank's card, ``cuda:LOCAL_RANK`` (default: the
rank; torchrun sets it on every node). With ``HYPERNERF_PLATFORM=cpu`` every
rank runs on the CPU. ``HYPERNERF_DIST_TIMEOUT`` is the process group's
timeout in seconds (default 1800): a rank that waits longer at the
rendezvous or at a collective raises instead of hanging.

``spawn`` starts a launch of N ranks on this host (``python -m
hypernerf_tpu_torch.train --num_devices N``).
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Callable, Optional, Sequence

import torch

DEFAULT_TIMEOUT_S = 1800.0


def launch_env() -> Optional[dict]:
    """The launch this process belongs to: {'init_method', 'world_size',
    'rank', 'local_rank'}, or None outside a launch."""
    coordinator = os.environ.get('HYPERNERF_COORDINATOR')
    if coordinator:
        world = int(os.environ.get('HYPERNERF_NUM_PROCESSES', '1'))
        rank = int(os.environ.get('HYPERNERF_PROCESS_ID', '0'))
        init = f'tcp://{coordinator}'
    elif 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        world, rank = int(os.environ['WORLD_SIZE']), int(os.environ['RANK'])
        init = 'env://'
    else:
        return None
    if not 0 <= rank < world:
        raise ValueError(f'rank {rank} outside a world of {world}')
    return dict(init_method=init, world_size=world, rank=rank,
                local_rank=int(os.environ.get('LOCAL_RANK', rank)))


def rank_device(local_rank: Optional[int] = None) -> torch.device:
    """The device a process runs on: the CPU when ``HYPERNERF_PLATFORM=cpu``
    asks for it, else the CUDA card (``cuda:local_rank`` when given). No
    card, or no card of that index, is an error, never a silent CPU run."""
    platform = os.environ.get('HYPERNERF_PLATFORM', 'cuda').lower()
    if platform == 'cpu':
        return torch.device('cpu')
    if platform not in ('cuda', 'gpu'):
        raise SystemExit(f'HYPERNERF_PLATFORM={platform!r}: this package '
                         f'runs on cuda, or on cpu when asked')
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device: this entry point runs on the GPU; '
                         'set HYPERNERF_PLATFORM=cpu to run it on the CPU')
    if local_rank is None:
        return torch.device('cuda')
    count = torch.cuda.device_count()
    if local_rank >= count:
        raise SystemExit(f'local rank {local_rank} needs cuda:{local_rank}, '
                         f'but this machine has {count} CUDA device(s)')
    return torch.device('cuda', local_rank)


def dist_timeout() -> datetime.timedelta:
    """The process group's timeout: ``HYPERNERF_DIST_TIMEOUT`` seconds."""
    return datetime.timedelta(seconds=float(os.environ.get(
        'HYPERNERF_DIST_TIMEOUT', DEFAULT_TIMEOUT_S)))


def maybe_initialize_distributed(backend: Optional[str] = None) -> bool:
    """Join the launch of the environment (see the module docstring);
    returns True if this process is now, or already was, in a process
    group, False outside a launch. ``backend``: NCCL for a rank on a card
    and gloo on the CPU by default; gloo puts several ranks on one card,
    which NCCL refuses. The group's timeout is ``dist_timeout()``."""
    import torch.distributed as dist
    if dist.is_initialized():
        return True
    env = launch_env()
    if env is None:
        return False
    device = rank_device(env['local_rank'])
    if device.type == 'cuda':
        torch.cuda.set_device(device)
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    dist.init_process_group(backend, init_method=env['init_method'],
                            world_size=env['world_size'], rank=env['rank'],
                            timeout=dist_timeout())
    return True


def is_primary_host() -> bool:
    """Rank 0 of the launch, or a process outside any launch."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def shutdown() -> None:
    """Leave the process group, if there is one."""
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket() as s:
        s.bind(('localhost', 0))
        return s.getsockname()[1]


def spawn(fn: Callable, world_size: int, args: tuple = (),
          local_ranks: Optional[Sequence[int]] = None) -> None:
    """Run ``fn(*args)`` in ``world_size`` new processes on this host, rank
    r with ``HYPERNERF_COORDINATOR`` on a free localhost port,
    ``HYPERNERF_NUM_PROCESSES``, ``HYPERNERF_PROCESS_ID=r`` and
    ``LOCAL_RANK=local_ranks[r]`` (default r) in its environment, so that
    ``maybe_initialize_distributed`` joins them into one launch. Returns
    when every rank has ended; an exception in a rank stops the others and
    is raised here. ``fn`` must be importable (spawned processes start a
    fresh interpreter)."""
    import torch.multiprocessing as mp
    local_ranks = tuple(range(world_size) if local_ranks is None
                        else local_ranks)
    if len(local_ranks) != world_size:
        raise ValueError(f'{len(local_ranks)} local ranks for a world of '
                         f'{world_size}')
    mp.start_processes(_run_rank, nprocs=world_size, start_method='spawn',
                       args=(fn, args, world_size,
                             f'localhost:{free_port()}', local_ranks))


def _run_rank(rank: int, fn: Callable, args: tuple, world_size: int,
              coordinator: str, local_ranks: Sequence[int]) -> None:
    os.environ.update(HYPERNERF_COORDINATOR=coordinator,
                      HYPERNERF_NUM_PROCESSES=str(world_size),
                      HYPERNERF_PROCESS_ID=str(rank),
                      LOCAL_RANK=str(local_ranks[rank]))
    fn(*args)
