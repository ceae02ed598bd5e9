"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing this package builds and loads nothing: the CUDA library is
compiled (``build.py``) the first time a kernel is launched on a CUDA
tensor.
"""

from hypernerf_tpu_torch.kernels.fused_composite import (
    fused_composite, fused_composite_plain)
from hypernerf_tpu_torch.kernels.fused_level import (Level, fused_level,
                                                     fused_level_plain)
