"""NerfModel: the flagship HyperNeRF render path
(port of ``hypernerf_tpu/models/nerf.py``, its fused coarse + fine render).

One level is two kernels: the level forward (warp field, hyper sheet and
template for every sample) and the compositing forward; the coarse
compositing call also draws the fine depths and merges them with the
coarse ones, as ``nerf.py:902-986`` does. The deterministic render draws
nothing: coarse z is a linspace and the fine u is linspace(0, 1, N).

Configurations other than the flagship family raise NotImplementedError
naming the ROADMAP item that will port them.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from hypernerf_tpu.configs import NerfConfig
from hypernerf_tpu_torch.kernels import Level, fused_composite, fused_level
from hypernerf_tpu_torch.models.modules import (GLOEmbed, HyperSheetMLP,
                                                NerfMLP, torch_dtype)
from hypernerf_tpu_torch.models.warping import TranslationField
from hypernerf_tpu_torch.ops.posenc import posenc_orig, posenc_orig_channels
from hypernerf_tpu_torch.ops.sampling import sample_along_rays

WARP_EMBED_KEY = 'time'


def unsupported(cfg: NerfConfig) -> list:
    """What ``cfg`` asks for that the port does not have yet, with the
    ROADMAP item that ports it."""
    out = []
    if not cfg.use_warp or cfg.warp_field_type != 'translation':
        out.append(f'warp {cfg.warp_field_type!r} / use_warp='
                   f'{cfg.use_warp} (ROADMAP A.9)')
    if cfg.hyper_slice_method != 'bendy_sheet':
        out.append(f'slicing {cfg.hyper_slice_method!r} (ROADMAP A.9)')
    if not cfg.use_original_embed:
        out.append('the Nerfies anneal encoding (ROADMAP A.9)')
    if cfg.use_nerf_embed or not cfg.share_glo or not cfg.use_viewdirs:
        out.append('conditions other than shared GLO + viewdirs '
                   '(ROADMAP A.9)')
    if cfg.use_occupancy_grid:
        out.append('the occupancy grid (ROADMAP A.10)')
    if cfg.alpha_channels != 1 or cfg.rgb_channels != 3:
        out.append('heads other than rgb 3 + alpha 1 (ROADMAP A.9)')
    return out


class NerfModel(nn.Module):
    """HyperNeRF, flagship family: translation warp, bendy sheet,
    posenc_orig, shared GLO embedding, viewdir-conditioned rgb."""

    def __init__(self, config: NerfConfig):
        super().__init__()
        missing = unsupported(config)
        if missing:
            raise NotImplementedError('not ported yet: ' + '; '.join(missing))
        cfg = config
        self.config = cfg
        dt = torch_dtype(cfg.compute_dtype)
        self.warp_embed = GLOEmbed(cfg.num_embeddings, cfg.glo_dim)
        self.warp_field = TranslationField(
            cfg.glo_dim, cfg.warp_depth, cfg.warp_width, cfg.warp_freq,
            cfg.skips, dtype=dt)
        self.hyper_sheet_mlp = HyperSheetMLP(
            cfg.glo_dim, cfg.hyper_slice_out_dim, cfg.hyper_sheet_depth,
            cfg.hyper_sheet_width, cfg.hyper_sheet_freq, cfg.skips,
            cfg.hyper_sheet_use_residual, dtype=dt)
        template = dict(
            in_ch=(posenc_orig_channels(3, cfg.xyz_freq)
                   + posenc_orig_channels(cfg.hyper_slice_out_dim,
                                          cfg.hyper_freq)),
            rgb_cond_ch=posenc_orig_channels(3, cfg.dir_freq),
            trunk_depth=cfg.trunk_depth, trunk_width=cfg.trunk_width,
            rgb_branch_depth=cfg.rgb_branch_depth,
            rgb_branch_width=cfg.rgb_branch_width,
            rgb_channels=cfg.rgb_channels,
            alpha_channels=cfg.alpha_channels, skips=cfg.skips, dtype=dt)
        self.nerf_coarse = NerfMLP(**template)
        if cfg.num_fine_samples > 0:
            self.nerf_fine = NerfMLP(**template)
        # The two kernel wrappers of a level. They launch the CUDA kernels on
        # CUDA tensors and run their plain versions on CPU tensors; a caller
        # that times the plain versions on the card swaps these.
        self.level_op = fused_level
        self.composite_op = fused_composite

    def level(self, name: str) -> Level:
        cfg = self.config
        template = self.nerf_fine if name == 'fine' else self.nerf_coarse
        return Level(self.warp_field, self.hyper_sheet_mlp, template,
                     cfg.xyz_freq, cfg.hyper_freq)

    def render_level(self, name, z_vals, origins, directions, embed,
                     rgb_cond, fine_u=None) -> Dict[str, torch.Tensor]:
        packed = self.level_op(self.level(name), z_vals, origins, directions,
                               embed, rgb_cond)
        return self.composite_op(
            packed, z_vals, directions, fine_u,
            use_white_background=self.config.use_white_background,
            sample_at_infinity=self.config.use_sample_at_infinity)

    def forward(self, rays_dict: Dict[str, Any], deterministic: bool = True,
                return_weights: bool = True) -> Dict[str, Dict]:
        """Render a batch of rays.

        Args:
          rays_dict: ``ops.ray_dict.prepare_ray_dict`` output: origins,
            directions (B, 3), optional viewdirs, per-ray near / far (B,),
            metadata ids (B, 1).
          deterministic: the render path (no stratified jitter, no sigma
            noise). Stochastic rendering belongs to the train step.

        Returns:
          {'coarse': {...}, 'fine': {...}} with per-ray rgb / depth /
          med_depth / acc (and weights when ``return_weights``).
        """
        cfg = self.config
        if cfg.use_stratified_sampling and not deterministic:
            raise NotImplementedError('stochastic rendering (stratified '
                                      'jitter, sigma noise) is the train '
                                      'step, ROADMAP A.5')
        origins = rays_dict['origins'].contiguous()
        directions = rays_dict['directions'].contiguous()
        viewdirs = rays_dict.get('viewdirs')
        if viewdirs is None:
            viewdirs = directions  # unnormalised, as the JAX model does
        near = rays_dict.get('near', cfg.near)
        far = rays_dict.get('far', cfg.far)
        n_rays = origins.shape[0]

        z_vals, _ = sample_along_rays(origins, directions,
                                      cfg.num_coarse_samples, near, far,
                                      False, cfg.use_linear_disparity)
        z_vals = z_vals.contiguous()
        embed = self.warp_embed(rays_dict['metadata'][WARP_EMBED_KEY])
        rgb_cond = posenc_orig(viewdirs, cfg.dir_freq)
        n_fine = cfg.num_fine_samples
        fine_u = None
        if n_fine:
            fine_u = torch.linspace(0.0, 1.0, n_fine, dtype=z_vals.dtype,
                                    device=z_vals.device)
            fine_u = fine_u.expand(n_rays, n_fine).contiguous()
        out = {'coarse': self.render_level('coarse', z_vals, origins,
                                           directions, embed, rgb_cond,
                                           fine_u)}
        if n_fine:
            z_union = out['coarse'].pop('z_union')
            out['fine'] = self.render_level('fine', z_union, origins,
                                            directions, embed, rgb_cond)
        if not return_weights:
            for res in out.values():
                res.pop('weights', None)
        return out
