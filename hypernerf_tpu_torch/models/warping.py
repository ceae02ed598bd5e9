"""Warp fields (port of ``hypernerf_tpu/models/warping.py``): the translation
field, the SE(3) field and the quaternion field.

On CUDA tensors a field runs through its hand-written kernels
(``kernels.fused_field`` / ``kernels.fused_se3``, forward and backward); on
CPU tensors through the dense code below, with autograd. The SE(3) and
quaternion retractions carry their hand-derived backward on both paths
(``ops.rigid_body``, ``ops.quaternion``).

``jacobian`` gives d warped / d points for the elastic loss, through the
warp-Jacobian kernels (``kernels.fused_jacobian``,
``kernels.fused_se3_jacobian`` and the retraction's point-Jacobian
``rigid_body.retraction_jacobian``) on CUDA tensors and their plain versions
on CPU tensors, which equal the JAX package's dense ``_warp_jacobian``."""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from hypernerf_tpu_torch.models.modules import (MLP, field_kernel,
                                                xavier_normal_)
from hypernerf_tpu_torch.ops import quaternion, rigid_body
from hypernerf_tpu_torch.ops.posenc import (posenc, posenc_channels,
                                            posenc_orig, posenc_orig_channels)


class TranslationField(nn.Module):
    """warped = points + MLP(posenc_orig(points, n_freq) ++ embed).

    Xavier-normal hidden init, U(0, 1e-4) output init.
    """

    kind = 'translation'

    def __init__(self, embed_ch: int, depth: int = 6, width: int = 128,
                 n_freq: int = 10, skips: Sequence[int] = (4,),
                 dtype=torch.float32):
        super().__init__()
        self.n_freq = n_freq
        self.mlp = MLP(posenc_orig_channels(3, n_freq) + embed_ch, 3, depth,
                       width, skips, hidden_init=xavier_normal_,
                       output_init=lambda w: nn.init.uniform_(w, 0.0, 1e-4),
                       dtype=dtype)

    def forward(self, points: torch.Tensor, embed: torch.Tensor,
                extra_params=None):
        """points (..., 3), embed (..., E) per sample -> warped (..., 3)."""
        if points.is_cuda:
            return points + field_kernel(self.mlp, self.n_freq, points,
                                         embed).to(points.dtype)
        inputs = torch.cat([posenc_orig(points, self.n_freq),
                            embed.to(points.dtype)], dim=-1)
        return points + self.mlp(inputs).to(points.dtype)

    def jacobian(self, points: torch.Tensor, embed: torch.Tensor,
                 extra_params=None) -> torch.Tensor:
        """(..., 3, 3) d warped_i / d points_k (jacrev layout); the
        embedding's gradient through it is exactly zero."""
        # The kernels' wrappers import this module: import at call time.
        from hypernerf_tpu_torch.kernels.fused_jacobian import \
            fused_warp_jacobian
        return fused_warp_jacobian(self.mlp, self.n_freq, points, embed)


class SE3Field(nn.Module):
    """A per-point rigid transform through the se(3) exponential map:
    posenc(points, min_deg..max_deg) ++ embed -> ``trunk`` (Xavier-normal,
    linear logit of the trunk's width) -> the heads ``w_net`` and ``v_net``
    (one linear layer each, U(0, 1e-4) weights and zero biases, so that the
    warp starts at the identity) -> the screw retraction
    ``rigid_body.se3_warp_vec(w, v, points)`` in fp32.

    ``extra_params['warp_alpha']`` windows the encoding's bands (None or
    absent: no window). With ``use_posenc_identity`` the encoding starts
    with the points themselves (the JAX field's column order); the JAX
    package has no kernel for such a field and runs it in XLA, and so this
    one runs in tensor code on every device (``runs_kernels``), forward and
    Jacobian. No model configuration sets it.
    """

    def __init__(self, embed_ch: int, trunk_depth: int = 6,
                 trunk_width: int = 128, min_deg: int = 0, max_deg: int = 8,
                 skips: Sequence[int] = (4,), use_metadata: bool = True,
                 use_posenc_identity: bool = False, dtype=torch.float32):
        super().__init__()
        self.embed_ch, self.use_metadata = embed_ch, use_metadata
        self.min_deg, self.max_deg = min_deg, max_deg
        self.use_posenc_identity = use_posenc_identity
        in_ch = posenc_channels(3, min_deg, max_deg, use_posenc_identity) + (
            embed_ch if use_metadata else 0)
        self.trunk = MLP(in_ch, trunk_width, trunk_depth, trunk_width, skips,
                         hidden_init=xavier_normal_, dtype=dtype)
        head = dict(depth=0, width=trunk_width,
                    output_init=lambda w: nn.init.uniform_(w, 0.0, 1e-4),
                    torch_default_bias=False, dtype=dtype)
        self.w_net = MLP(trunk_width, 3, **head)
        self.v_net = MLP(trunk_width, 3, **head)

    kind = 'se3'
    retract = staticmethod(rigid_body.se3_warp_vec)
    retract_bwd = staticmethod(rigid_body.se3_warp_vec_bwd)

    def runs_kernels(self, points: torch.Tensor) -> bool:
        """Whether ``points`` go through the trunk kernels: CUDA tensors,
        unless the encoding has the identity (tensor code, as the JAX
        package runs such a field)."""
        return points.is_cuda and not self.use_posenc_identity

    def _wv(self, points, embed, alpha):
        """(w, v) of the trunk and heads in tensor code."""
        inputs = posenc(points, self.min_deg, self.max_deg,
                        use_identity=self.use_posenc_identity, alpha=alpha)
        if self.use_metadata:
            inputs = torch.cat([inputs, embed.to(inputs.dtype)], dim=-1)
        trunk = self.trunk(inputs)
        return (self.w_net(trunk).to(points.dtype),
                self.v_net(trunk).to(points.dtype))

    def forward(self, points: torch.Tensor, embed: torch.Tensor,
                extra_params=None):
        """points (..., 3), embed (..., E) per sample -> warped (..., 3)."""
        alpha = (extra_params or {}).get('warp_alpha')
        pts = points.to(torch.promote_types(points.dtype, torch.float32))
        if self.runs_kernels(points):
            # The kernels' wrappers import this module: import at call time.
            from hypernerf_tpu_torch.kernels.fused_se3 import (
                fused_se3_wv, se3_encoding_scales)
            if not self.use_metadata:
                raise NotImplementedError(
                    'the SE(3) trunk kernel takes [points | embedding] rows '
                    '(ROADMAP A.13)')
            raw = torch.cat([pts, embed.to(pts.dtype)], dim=-1)
            scales = None if alpha is None else se3_encoding_scales(
                self, alpha, points.device)
            w, v = fused_se3_wv(self, raw.reshape(-1, raw.shape[-1]).float(),
                                scales)
            return self.retract(w.reshape(pts.shape), v.reshape(pts.shape),
                                pts)
        w, v = self._wv(pts, embed, alpha)
        return self.retract(w, v, pts)

    def jacobian(self, points: torch.Tensor, embed: torch.Tensor,
                 extra_params=None) -> torch.Tensor:
        """(..., 3, 3) d warped_i / d points_k (jacrev layout): the
        trunk's (w, v) and point-tangents (``fused_se3_wv_tangents``; with
        the identity in the encoding, forward-mode derivatives of the tensor
        code, as the JAX package's dense Jacobian), then the retraction's
        point-Jacobian in tensor code."""
        from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
        from hypernerf_tpu_torch.kernels.fused_se3_jacobian import \
            fused_se3_wv_tangents
        alpha = (extra_params or {}).get('warp_alpha')
        pts = points.reshape(-1, 3)
        pts = pts.to(torch.promote_types(pts.dtype, torch.float32))
        if self.use_posenc_identity:
            emb = embed.reshape(-1, embed.shape[-1])
            w, v = self._wv(pts, emb, alpha)
            tangents = []
            for k in range(3):
                basis = torch.zeros_like(pts)
                basis[:, k] = 1.0
                tangents.append(torch.func.jvp(
                    lambda p: self._wv(p, emb, alpha), (pts,), (basis,))[1])
            dw, dv = (torch.stack([t[i] for t in tangents], dim=-1)
                      for i in (0, 1))
            jac = rigid_body.retraction_jacobian(self.retract_bwd, w, v, pts,
                                                 dw, dv)
            return jac.reshape(*points.shape[:-1], 3, 3)
        raw = pts if not self.use_metadata else torch.cat(
            [pts, embed.reshape(-1, embed.shape[-1]).to(pts.dtype)], dim=-1)
        scales = None if alpha is None else se3_encoding_scales(
            self, alpha, points.device)
        w, v, dw, dv = fused_se3_wv_tangents(self, raw.contiguous(), scales)
        jac = rigid_body.retraction_jacobian(self.retract_bwd, w, v, pts, dw,
                                             dv)
        return jac.reshape(*points.shape[:-1], 3, 3)


class QuaternionField(SE3Field):
    """The SE(3) field's trunk and heads with another retraction: the
    rotation by the quaternion exponential of ``w``, then the translation
    ``v``, with no screw coupling (``quaternion.quat_warp_vec``)."""

    kind = 'quaternion'
    retract = staticmethod(quaternion.quat_warp_vec)
    retract_bwd = staticmethod(quaternion.quat_warp_vec_bwd)


WARP_FIELDS = {'se3': SE3Field, 'quaternion': QuaternionField}
