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

from hypernerf_tpu_torch.kernels.f32 import (fused_field_bwd_f32,
                                             fused_field_f32,
                                             fused_fields_bwd_f32,
                                             fused_jacobian_bwd_f32,
                                             fused_jacobian_f32,
                                             fused_level_f32,
                                             fused_se3_bwd_f32,
                                             fused_se3_f32,
                                             fused_se3_jacobian_bwd_f32,
                                             fused_se3_jacobian_f32,
                                             fused_template_bwd_f32,
                                             fused_template_f32)
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


def counted():
    """({kernel name: wrapper}, {name: plain version}) of every kernel (the
    float32 kernels of rows 1, 9, 5, 8 and 10 to 17 under names of
    their own, beside their plain versions, which are the bf16 rows' plain
    versions at that dtype). A wrapper adds one to its ``launches`` where it
    launches its kernel, a plain version one to its ``calls``; both are
    plain attributes, set to 0 by whoever counts."""
    wrappers = {'fused_level_fwd': fused_level,
                'fused_composite_fwd': fused_composite,
                'fused_template_bwd': fused_template_bwd,
                'fused_fields_bwd': fused_fields_bwd,
                'fused_composite_bwd': fused_composite_bwd,
                'fused_field_fwd': fused_field,
                'fused_field_bwd': fused_field_bwd,
                'fused_template_fwd': fused_template,
                'fused_se3_fwd': fused_se3_wv,
                'fused_se3_bwd': fused_se3_bwd,
                'fused_jacobian_fwd': fused_warp_jacobian,
                'fused_jacobian_bwd': fused_jacobian_bwd,
                'fused_se3_jacobian_fwd': fused_se3_wv_tangents,
                'fused_se3_jacobian_bwd': fused_se3_jacobian_bwd,
                'fused_level_fwd_f32': fused_level_f32,
                'fused_template_bwd_f32': fused_template_bwd_f32,
                'fused_fields_bwd_f32': fused_fields_bwd_f32,
                'fused_template_fwd_f32': fused_template_f32,
                'fused_field_fwd_f32': fused_field_f32,
                'fused_field_bwd_f32': fused_field_bwd_f32,
                'fused_se3_fwd_f32': fused_se3_f32,
                'fused_se3_bwd_f32': fused_se3_bwd_f32,
                'fused_jacobian_fwd_f32': fused_jacobian_f32,
                'fused_jacobian_bwd_f32': fused_jacobian_bwd_f32,
                'fused_se3_jacobian_fwd_f32': fused_se3_jacobian_f32,
                'fused_se3_jacobian_bwd_f32': fused_se3_jacobian_bwd_f32}
    plains = [fused_level_plain, fused_composite_plain,
              fused_template_bwd_plain, fused_fields_bwd_plain,
              fused_composite_bwd_plain, fused_field_plain,
              fused_field_bwd_plain, fused_template_plain, fused_se3_plain,
              fused_se3_bwd_plain, fused_jacobian_plain,
              fused_jacobian_bwd_plain, fused_se3_jacobian_plain,
              fused_se3_jacobian_bwd_plain]
    return wrappers, {fn.__name__: fn for fn in plains}
