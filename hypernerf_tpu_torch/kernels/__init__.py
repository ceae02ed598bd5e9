"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Importing this package builds and loads nothing: the CUDA library is
compiled (``build.py``) the first time a kernel is launched on a CUDA
tensor.

Every wrapper, forward and backward, runs its plain version on CPU tensors
and launches its kernel (or raises) on CUDA tensors. ``common.runs_plain``
makes that choice for all of them and is looked up at call time: rebinding
that one name is how a caller runs the plain versions on the card, through
the same autograd Functions, to time them or to hold a step against them.
"""

from hypernerf_tpu_torch.kernels.fused_composite import (
    FusedCompositeFn, fused_composite, fused_composite_bwd,
    fused_composite_bwd_plain, fused_composite_plain)
from hypernerf_tpu_torch.kernels.fused_field import (
    FusedFieldFn, fused_field, fused_field_bwd, fused_field_bwd_plain,
    fused_field_plain)
from hypernerf_tpu_torch.kernels.fused_jacobian import (
    FusedJacobianFn, fused_jacobian_bwd, fused_jacobian_bwd_plain,
    fused_jacobian_plain, fused_warp_jacobian)
from hypernerf_tpu_torch.kernels.fused_level import (
    FusedLevelFn, Level, fused_fields_bwd, fused_fields_bwd_plain,
    fused_level, fused_level_plain)
from hypernerf_tpu_torch.kernels.fused_mlp import (
    FusedTemplateFn, Template, fused_template, fused_template_bwd,
    fused_template_bwd_plain, fused_template_plain)
from hypernerf_tpu_torch.kernels.fused_se3 import (
    FusedSE3Fn, fused_se3_bwd, fused_se3_bwd_plain, fused_se3_plain,
    fused_se3_wv)
from hypernerf_tpu_torch.kernels.fused_se3_jacobian import (
    FusedSE3JacobianFn, fused_se3_jacobian_bwd, fused_se3_jacobian_bwd_plain,
    fused_se3_jacobian_plain, fused_se3_wv_tangents)
