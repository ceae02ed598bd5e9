"""Train HyperNeRF: ``python -m hypernerf_tpu_torch.train`` (the port of the
repository's ``train.py``), with its flags (``hypernerf_tpu_torch.opt``).

  python -m hypernerf_tpu_torch.train --dataset_name llff \
      --root_dir /data/scene --N_importance 64 --img_wh 504 378 \
      --num_epochs 30 --batch_size 1024 --optimizer adam --lr 5e-4 \
      --lr_scheduler steplr --decay_step 10 20 --decay_gamma 0.5 \
      --exp_name exp

Trains on the CUDA card (``parallel.distributed.rank_device``: no card is an
error; with ``HYPERNERF_PLATFORM=cpu`` it trains on the CPU, through the
kernels' plain versions), writes checkpoints to ``ckpts/<exp_name>/step_N``
and metrics to ``logs/<exp_name>/metrics.csv`` (and TensorBoard where it is
installed), and prints the dataset, the step lines and the final metrics.

Several GPUs (data parallelism, ``parallel/``): ``--num_devices N`` (or
``--num_gpus N``) starts N ranks on this host, one process per card
(``cuda:0`` to ``cuda:N-1``, NCCL; N above the cards is an error; with
``HYPERNERF_PLATFORM=cpu`` N gloo processes on the CPU). ``--batch_size`` is
the global batch, which N must divide. A process started by ``torchrun``, or
with ``HYPERNERF_COORDINATOR`` / ``HYPERNERF_NUM_PROCESSES`` /
``HYPERNERF_PROCESS_ID`` set (``parallel.distributed``), joins that launch
instead. Every rank trains on its share of each batch; rank 0 prints
``Device mesh: N x cuda``, logs and writes the checkpoints.
``--shard_optimizer_state`` shards the optimizer's moments over the ranks
(ZeRO-1).
"""

from __future__ import annotations

import sys


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, and return the
    ``training.trainer.Trainer`` after its ``fit``; with ``--num_devices``
    outside a launch, start the ranks, wait for them and return None."""
    from hypernerf_tpu_torch.opt import get_opts
    from hypernerf_tpu_torch.parallel import distributed

    args = get_opts(argv)
    num_devices = args.num_devices or args.num_gpus
    if num_devices is not None and distributed.launch_env() is None:
        launch(num_devices, args, sys.argv[1:] if argv is None else argv)
        return None
    joined = distributed.maybe_initialize_distributed()
    try:
        return _train(args, joined, num_devices)
    finally:
        if joined:
            distributed.shutdown()


def launch(num_devices: int, args, argv) -> None:
    """Start ``num_devices`` ranks that each run ``main(argv)`` in one
    launch on this host. Refused before anything starts: a batch that the
    ranks do not divide, and more ranks than CUDA cards."""
    import torch

    from hypernerf_tpu_torch.parallel import distributed
    if num_devices < 1:
        raise ValueError(f'--num_devices {num_devices}: at least 1')
    if args.batch_size % num_devices:
        raise ValueError(f'batch_size {args.batch_size} must be divisible '
                         f'by the number of ranks {num_devices}')
    if distributed.rank_device().type == 'cuda':
        count = torch.cuda.device_count()
        if num_devices > count:
            raise SystemExit(f'--num_devices {num_devices}: more ranks than '
                             f'CUDA devices ({count}); one rank a card')
    distributed.spawn(main, num_devices, (list(argv),))


def _train(args, joined: bool, num_devices):
    from hypernerf_tpu_torch.opt import configs_from_args
    from hypernerf_tpu_torch.parallel.distributed import rank_device
    from hypernerf_tpu_torch.parallel.mesh import create_mesh
    from hypernerf_tpu_torch.training.trainer import Trainer
    from hypernerf_tpu_torch.utils.logging import MetricsLogger

    mesh = create_mesh(num_devices) if joined else None
    device = mesh.device if mesh else rank_device()
    nerf_cfg, train_cfg = configs_from_args(args)
    primary = mesh is None or mesh.is_primary
    if mesh is None:
        print(f'Device: {device}', flush=True)
    elif primary:
        print(f'Device mesh: {mesh.world_size} x {device.type}', flush=True)
    logger = (MetricsLogger(train_cfg.log_dir, train_cfg.exp_name)
              if primary else None)
    try:
        trainer = Trainer(nerf_cfg, train_cfg, device, logger=logger,
                          mesh=mesh)
        if primary:
            print(f'Dataset: {len(trainer.train_dataset.all_rays):,} rays, '
                  f'{trainer.steps_per_epoch} steps/epoch, '
                  f'{trainer.total_steps} total steps', flush=True)
        metrics = trainer.fit()
        if primary:
            print('Final metrics:', metrics, flush=True)
    finally:
        if logger is not None:
            logger.close()
    return trainer


if __name__ == '__main__':
    main()
