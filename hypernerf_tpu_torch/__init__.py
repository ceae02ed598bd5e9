"""hypernerf_tpu_torch — the PyTorch / CUDA port of ``hypernerf_tpu``.

The JAX package stays the reference; this package mirrors its layout and is
held against it by ``tests/test_torch_*.py``. It imports ``torch`` and never
``jax``, and nothing of the JAX package: ``configs``, ``opt``, ``datasets``
and ``utils.visualization`` are its own copies of those numpy-only modules
(same fields, flags and defaults). Only the tests and the converters under
``tools/`` import both packages.

Layer map:
  ops/       posenc, ray sampling, volume rendering, ray dicts (plain torch)
  models/    nn.Modules: MLPs, GLO embeddings, the warp field, NerfModel
  kernels/   hand-written CUDA kernels for Hopper (sources in kernels/csrc/),
             each beside its plain PyTorch version
  training/  the train step (losses, optimizers, train_state), the trainer,
             the tiled image renderer, metrics, checkpoints
  utils/     depth visualization, the metrics logger
  flagship.py the flagship configuration, model, rays and train setup
  train.py   ``python -m hypernerf_tpu_torch.train`` (the train entry point)
  eval.py    ``python -m hypernerf_tpu_torch.eval`` (the render entry point)
  convert.py flax params -> this package's state dict
"""

__version__ = "0.1.0"
