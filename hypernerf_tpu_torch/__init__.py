"""hypernerf_tpu_torch — the PyTorch / CUDA port of ``hypernerf_tpu``.

The JAX package stays the reference; this package mirrors its layout and is
held against it by ``tests/test_torch_*.py``. It imports ``torch`` and never
``jax``: from the JAX package it reuses only the framework-free modules
(``configs``, ``opt``, ``datasets``, ``utils.visualization``).

Layer map:
  ops/       posenc, ray sampling, volume rendering, ray dicts (plain torch)
  models/    nn.Modules: MLPs, GLO embeddings, the warp field, NerfModel
  kernels/   hand-written CUDA kernels for Hopper (sources in kernels/csrc/),
             each beside its plain PyTorch version
  training/  tiled image renderer, metrics, the port's weight file
  eval.py    ``python -m hypernerf_tpu_torch.eval`` (the render entry point)
  convert.py flax params -> this package's state dict
"""

__version__ = "0.1.0"
