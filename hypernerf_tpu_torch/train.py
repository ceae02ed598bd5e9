"""Train HyperNeRF: ``python -m hypernerf_tpu_torch.train`` (the port of the
repository's ``train.py``), with its flags (``hypernerf_tpu_torch.opt``).

  python -m hypernerf_tpu_torch.train --dataset_name llff \
      --root_dir /data/scene --N_importance 64 --img_wh 504 378 \
      --num_epochs 30 --batch_size 1024 --optimizer adam --lr 5e-4 \
      --lr_scheduler steplr --decay_step 10 20 --decay_gamma 0.5 \
      --exp_name exp

Trains on the CUDA card (``eval.render_device``: no card is an error; with
``HYPERNERF_PLATFORM=cpu`` it trains on the CPU, through the kernels' plain
versions), writes checkpoints to ``ckpts/<exp_name>/step_N`` and metrics
to ``logs/<exp_name>/metrics.csv`` (and TensorBoard where it is installed),
and prints the dataset, the step lines and the final metrics. One device:
``--num_devices`` / ``--num_gpus`` above 1 raise (multi-GPU training is
ROADMAP A.12).
"""

from __future__ import annotations


def main(argv=None):
    """Parse ``argv`` (default: the command line), train, and return the
    ``training.trainer.Trainer`` after its ``fit``."""
    from hypernerf_tpu_torch.eval import render_device
    from hypernerf_tpu_torch.opt import configs_from_args, get_opts

    args = get_opts(argv)
    num_devices = args.num_devices or args.num_gpus
    if num_devices is not None and num_devices > 1:
        raise NotImplementedError(
            f'--num_devices {num_devices}: the port trains on one device; '
            f'multi-GPU training is ROADMAP A.12')
    device = render_device()
    nerf_cfg, train_cfg = configs_from_args(args)

    from hypernerf_tpu_torch.training.trainer import Trainer
    from hypernerf_tpu_torch.utils.logging import MetricsLogger

    print(f'Device: {device}', flush=True)
    logger = MetricsLogger(train_cfg.log_dir, train_cfg.exp_name)
    try:
        trainer = Trainer(nerf_cfg, train_cfg, device, logger=logger)
        print(f'Dataset: {len(trainer.train_dataset.all_rays):,} rays, '
              f'{trainer.steps_per_epoch} steps/epoch, '
              f'{trainer.total_steps} total steps', flush=True)
        metrics = trainer.fit()
        print('Final metrics:', metrics, flush=True)
    finally:
        logger.close()
    return trainer


if __name__ == '__main__':
    main()
