"""Data parallelism over several GPUs (port of ``hypernerf_tpu/parallel``):
the process group of a launch (``distributed``) and the data-parallel
context with its collectives (``mesh``)."""

from hypernerf_tpu_torch.parallel.mesh import (DataParallel, all_reduce_mean,
                                               create_mesh, gather_rows,
                                               replicate, shard_batch)
