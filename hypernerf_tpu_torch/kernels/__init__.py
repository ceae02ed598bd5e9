"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing this package builds and loads nothing: the CUDA library is
compiled (``build.py``) the first time a kernel is launched on a CUDA
tensor.
"""

from hypernerf_tpu_torch.kernels.fused_composite import (
    FusedCompositeFn, fused_composite, fused_composite_bwd,
    fused_composite_bwd_plain, fused_composite_plain)
from hypernerf_tpu_torch.kernels.fused_level import (
    FusedLevelFn, Level, fused_fields_bwd, fused_fields_bwd_plain,
    fused_level, fused_level_plain, fused_template_bwd,
    fused_template_bwd_plain)
