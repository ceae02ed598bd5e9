"""NerfModel: HyperNeRF with a translation, an SE(3) or a quaternion warp,
each with the bendy sheet or the axis-aligned plane and either template
encoding, rendering and training (port of ``hypernerf_tpu/models/nerf.py``).

A level runs on one of two branches, chosen as the JAX model chooses
(``nerf.py:755-764``):

* the fused branch, for the flagship family (warp on, bendy sheet or
  axis-aligned plane, one GLO table shared by warp and hyper coordinates)
  when no per-sample output is asked for: the level kernel (warp field or
  SE(3) / quaternion trunk, hyper sheet and template for every sample; with
  the plane, whose hyper coordinates are the ray's GLO embedding itself, no
  sheet) and the
  compositing kernel, which on the coarse level also draws the fine depths
  and merges them with the coarse ones;
* the per-module branch, for everything else this port has — a static NeRF
  (no warp, no hyper coordinates), separate GLO tables (``share_glo=False``),
  ``use_warp=False`` at call time, ``return_points``, a ``hyper_point``
  override in the metadata, the sheet's residual — and for ``query_sigma``:
  per-sample embeddings, the warp field and the hyper sheet each through the
  field kernel (the plane: the embedding broadcast over the samples), the
  template through the template kernel, then
  ``volumetric_rendering`` and ``sample_pdf`` in tensor code with autograd.

Every kernel has a hand-written backward kernel (``kernels/``), so the same
``forward`` serves the train step.

With ``return_warp_jacobian`` (the elastic loss) each level also returns
'warp_jacobian', d warped / d points from the warp field's ``jacobian`` (the
warp-Jacobian kernels). On the fused branch it is a side channel beside the
level kernel (the JAX model's ``_warp_jacobian_side_channel``): with
``elastic_jacobian_samples`` K > 0 and a stochastic forward it is taken at K
samples per ray drawn in proportion to the detached rendering weights, and
'warp_jacobian_weights' = sum(weights) / K, which stays differentiable, makes
the loss's weighted sum an unbiased estimate of the full one; otherwise at
every sample. The translation warp's embedding is detached there (its
gradient through J is exactly zero); the SE(3) / quaternion one is not. On the
per-module branch the Jacobian is taken at every sample.

``extra_params`` carries the annealing alphas. ``warp_alpha`` windows the
bands of the SE(3) / quaternion trunk's encoding, on both branches (None: no
window). With the Nerfies encoding (``use_original_embed=False``, the anneal
configurations) the template encodes the xyz over degrees 0..10 with
identity and the hyper coordinates (the sheet's 4, or the plane's 8) over
0..4 without, windowed by ``nerf_alpha`` and ``hyper_alpha``, and the
condition is posenc(viewdirs, 0, 4, identity) windowed by ``nerf_alpha``,
as the JAX model's ``query_template`` and
``get_condition_inputs``; on the level kernel and the template kernel the
window is a row of weights, an input of every call
(``fused_mlp.template_scales``). The condition and the window rows are
built once per model call and shared by both levels; a caller that renders
many chunks at fixed alphas builds the rows once (``window_rows``) and
passes them in. The translation warp and the sheet ignore the alphas, as in
the JAX model.

The deterministic render draws nothing: coarse z is a linspace and the fine
u is linspace(0, 1, N). The stochastic forward (training) draws, in the JAX
model's order, the stratified coarse jitter, the ascending fine u
(``sorted_uniform``) and one N(0, noise_std) sigma noise per level — from an
explicit ``torch.Generator``, or taken from ``draws`` so that a test can pass
in the numbers another implementation drew; the Jacobian subsample's
uniforms follow each level's noise.

With ``use_occupancy_grid`` and a grid passed to ``forward``
(``ops/occupancy.py``), the coarse depths are drawn from the grid's
piecewise-constant PDF (ascending uniforms in place of the jitter, a linspace
when deterministic), the coarse level composites without the fused fine draw
(row 2 with N = 0), and the fine depths come from ``sample_pdf`` on the
coarse weights gated by the grid, as in the JAX model; either branch runs
the level as it would without a grid.

The template's per-ray conditions are the JAX model's
(``get_condition_inputs``): the rgb condition is the view directions'
encoding (``use_viewdirs``) followed, with ``use_nerf_embed`` and
``use_rgb_condition``, by the nerf embedding (the per-frame appearance code:
the warp table's with one GLO table, else a table of its own that reads the
'warp' metadata key); the alpha condition is that embedding with
``use_alpha_condition``. Either may be empty: an empty alpha condition is
none, an empty rgb condition (``use_viewdirs=False`` without the rgb
condition) runs the same kernels with a condition of 0 columns, where the
JAX model leaves its kernels for XLA. ``query_sigma`` takes the id's
conditions, so an alpha condition enters the density.

What is still missing raises NotImplementedError naming the ROADMAP item
that will port it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from hypernerf_tpu_torch.configs import NerfConfig
from hypernerf_tpu_torch.kernels import (Level, Template, fused_composite,
                                         fused_level, fused_template)
from hypernerf_tpu_torch.kernels.fused_mlp import (n_hyper, raw_pad,
                                                   template_scales)
from hypernerf_tpu_torch.kernels.fused_se3 import se3_encoding_scales
from hypernerf_tpu_torch.models.modules import (GLOEmbed, HyperSheetMLP,
                                                NerfMLP, torch_dtype)
from hypernerf_tpu_torch.models.warping import WARP_FIELDS, TranslationField
from hypernerf_tpu_torch.ops.occupancy import (config_bbox, gate_fine_weights,
                                               sample_occupancy_rays)
from hypernerf_tpu_torch.ops.posenc import (posenc, posenc_channels,
                                            posenc_orig, posenc_orig_channels)
from hypernerf_tpu_torch.ops.rendering import (compute_depth_index,
                                               filter_sigma, noise_regularize,
                                               volumetric_rendering)
from hypernerf_tpu_torch.ops.sampling import (sample_along_rays, sample_pdf,
                                              sorted_uniform,
                                              weighted_sample_indices)

# The metadata keys carried per ray, and which of them each table reads.
METADATA_KEYS = ('warp', 'camera', 'appearance', 'time')
WARP_EMBED_KEY = 'time'
HYPER_EMBED_KEY = 'time'
NERF_EMBED_KEY = 'warp'


def unsupported(cfg: NerfConfig) -> list:
    """What ``cfg`` asks for that the port does not have yet, with the
    ROADMAP item that ports it."""
    out = []
    if not cfg.use_original_embed:
        if (cfg.spatial_point_min_deg, cfg.hyper_point_min_deg,
                cfg.viewdir_min_deg) != (0, 0, 0):
            out.append('Nerfies bands from a degree other than 0 '
                       '(ROADMAP A.13)')
    if cfg.alpha_channels != 1 or cfg.rgb_channels != 3:
        out.append('heads other than rgb 3 + alpha 1 (ROADMAP B.3)')
    return out


class NerfModel(nn.Module):
    """HyperNeRF with a translation, SE(3) or quaternion warp (or none), a
    bendy sheet, an axis-aligned plane (the GLO embedding as the hyper
    coordinates) or no hyper coordinates, the posenc_orig or the Nerfies
    template encoding, one GLO table or two (or three, with a nerf
    embedding of its own), and the template's alpha and rgb conditions."""

    def __init__(self, config: NerfConfig):
        super().__init__()
        missing = unsupported(config)
        if missing:
            raise NotImplementedError('not ported yet: ' + '; '.join(missing))
        cfg = config
        self.config = cfg
        dt = torch_dtype(cfg.compute_dtype)
        # Hyper coordinates exist only behind the warp: without it the
        # template sees the bare points (``map_points``). The plane's are the
        # GLO embedding's glo_dim coordinates.
        plane = cfg.hyper_slice_method == 'axis_aligned_plane'
        hyper_ch = ((cfg.glo_dim if plane else cfg.hyper_slice_out_dim)
                    if cfg.use_warp and cfg.has_hyper else 0)
        if cfg.use_warp:
            self.warp_embed = GLOEmbed(cfg.num_embeddings, cfg.glo_dim)
            if cfg.warp_field_type == 'translation':
                self.warp_field = TranslationField(
                    cfg.glo_dim, cfg.warp_depth, cfg.warp_width,
                    cfg.warp_freq, cfg.skips, dtype=dt)
            else:
                self.warp_field = WARP_FIELDS[cfg.warp_field_type](
                    cfg.glo_dim, cfg.warp_depth, cfg.warp_width,
                    cfg.warp_min_deg, cfg.warp_max_deg, cfg.skips, dtype=dt)
        if hyper_ch and not cfg.hyper_use_warp_embed:
            self.hyper_embed = GLOEmbed(cfg.num_embeddings, cfg.glo_dim)
        if cfg.use_nerf_embed and not cfg.nerf_use_warp_embed:
            self.nerf_embed = GLOEmbed(cfg.num_embeddings, cfg.glo_dim)
        if hyper_ch and not plane:
            self.hyper_sheet_mlp = HyperSheetMLP(
                cfg.glo_dim, cfg.hyper_slice_out_dim, cfg.hyper_sheet_depth,
                cfg.hyper_sheet_width, cfg.hyper_sheet_freq, cfg.skips,
                cfg.hyper_sheet_use_residual, dtype=dt)
        if cfg.use_original_embed:
            in_ch = (posenc_orig_channels(3, cfg.xyz_freq)
                     + (posenc_orig_channels(hyper_ch, cfg.hyper_freq)
                        if hyper_ch else 0))
            cond_ch = posenc_orig_channels(3, cfg.dir_freq)
        else:
            in_ch = (posenc_channels(3, cfg.spatial_point_min_deg,
                                     cfg.spatial_point_max_deg, True)
                     + posenc_channels(hyper_ch, cfg.hyper_point_min_deg,
                                       cfg.hyper_point_max_deg))
            cond_ch = posenc_channels(3, cfg.viewdir_min_deg,
                                      cfg.viewdir_max_deg, True)
        # The conditions' widths (get_condition_inputs).
        embed_ch = cfg.glo_dim if cfg.use_nerf_embed else 0
        cond_ch = ((cond_ch if cfg.use_viewdirs else 0)
                   + (embed_ch if cfg.use_rgb_condition else 0))
        alpha_cond_ch = embed_ch if cfg.use_alpha_condition else 0
        template = dict(
            in_ch=in_ch, rgb_cond_ch=cond_ch, alpha_cond_ch=alpha_cond_ch,
            trunk_depth=cfg.trunk_depth, trunk_width=cfg.trunk_width,
            rgb_branch_depth=cfg.rgb_branch_depth,
            rgb_branch_width=cfg.rgb_branch_width,
            rgb_channels=cfg.rgb_channels,
            alpha_channels=cfg.alpha_channels, skips=cfg.skips, dtype=dt)
        self.nerf_coarse = NerfMLP(**template)
        if cfg.num_fine_samples > 0:
            self.nerf_fine = NerfMLP(**template)

    def _template(self, name: str) -> NerfMLP:
        return self.nerf_fine if name == 'fine' else self.nerf_coarse

    def _bands(self):
        """(xyz bands, hyper bands, Nerfies layout) of the template's
        encoding (``fused_mlp.Template``'s last three fields)."""
        cfg = self.config
        if cfg.use_original_embed:
            return cfg.xyz_freq, cfg.hyper_freq, False
        return (cfg.spatial_point_max_deg - cfg.spatial_point_min_deg,
                cfg.hyper_point_max_deg - cfg.hyper_point_min_deg, True)

    def level(self, name: str) -> Level:
        """The level's modules for the level kernels (no sheet: the
        plane)."""
        return Level(self.warp_field, getattr(self, 'hyper_sheet_mlp', None),
                     self._template(name), *self._bands())

    # ------------------------------------------------------------------ embeds

    @staticmethod
    def _encode_embed(table: GLOEmbed, meta):
        """(*, 1) ids, or (*, 3) [left id, right id, progression in [0, 1]]
        interpolated between the two codes."""
        if meta.shape[-1] == 3:
            left, right = table(meta[..., 0]), table(meta[..., 1])
            progression = meta[..., 2:3].to(left.dtype)
            return (1.0 - progression) * left + progression * right
        return table(meta)

    def encode_warp_embed(self, metadata):
        return self._encode_embed(self.warp_embed, metadata[WARP_EMBED_KEY])

    def encode_hyper_embed(self, metadata):
        if not self.config.has_hyper_embed:
            raise ValueError('Model has no hyper embedding.')
        if self.config.hyper_use_warp_embed:
            return self.encode_warp_embed(metadata)
        return self._encode_embed(self.hyper_embed, metadata[HYPER_EMBED_KEY])

    def encode_nerf_embed(self, metadata):
        """The nerf embedding: the warp table's with one GLO table, else its
        own table's, which reads the 'warp' key (NERF_EMBED_KEY)."""
        if self.config.nerf_use_warp_embed:
            return self.encode_warp_embed(metadata)
        return self._encode_embed(self.nerf_embed, metadata[NERF_EMBED_KEY])

    def get_condition_inputs(self, viewdirs, metadata, extra_params=None,
                             metadata_encoded: bool = False):
        """The per-ray (alpha condition, rgb condition), each None when
        empty: the rgb condition is posenc_orig of the view directions, or
        with the Nerfies encoding their ``posenc`` with identity windowed by
        ``nerf_alpha`` (``use_viewdirs``), then the nerf embedding
        (``use_nerf_embed`` and ``use_rgb_condition``); the alpha condition
        is the nerf embedding (``use_alpha_condition``). With
        ``metadata_encoded`` the embedding is ``metadata['encoded_nerf']``,
        not the table's."""
        cfg = self.config
        alpha, rgb = [], []
        if cfg.use_viewdirs:
            if cfg.use_original_embed:
                rgb.append(posenc_orig(viewdirs, cfg.dir_freq))
            else:
                rgb.append(posenc(
                    viewdirs, cfg.viewdir_min_deg, cfg.viewdir_max_deg,
                    use_identity=True,
                    alpha=(extra_params or {}).get('nerf_alpha')))
        if cfg.use_nerf_embed:
            embed = (metadata['encoded_nerf'] if metadata_encoded
                     else self.encode_nerf_embed(metadata))
            if cfg.use_alpha_condition:
                alpha.append(embed)
            if cfg.use_rgb_condition:
                rgb.append(embed)
        return (torch.cat(alpha, dim=-1) if alpha else None,
                torch.cat(rgb, dim=-1) if rgb else None)

    @staticmethod
    def _kernel_rgb(rgb_cond, rays: int, like):
        """The rgb condition as the kernels take it: an empty one is (rays,
        0)."""
        if rgb_cond is None:
            return like.new_zeros((rays, 0))
        return rgb_cond

    def _template_scales(self, extra_params, device):
        """The template's window row at ``extra_params``' ``nerf_alpha``
        and ``hyper_alpha`` (the JAX model's ``_template_enc_scales``; the
        two levels' templates share its layout); None with the original
        encoding."""
        ep = extra_params or {}
        return template_scales(self.template_of('coarse'),
                               ep.get('nerf_alpha'), ep.get('hyper_alpha'),
                               device)

    def window_rows(self, extra_params, device):
        """The kernels' window rows at the annealing alphas
        ``extra_params``: (the SE(3) / quaternion trunk's, the template's),
        each None where there is no window. Tensors on ``device``, inputs of
        each kernel call, shared by both levels."""
        return (self._warp_scales(extra_params, device),
                self._template_scales(extra_params, device))

    def template_of(self, name: str) -> Template:
        return Template(self._template(name), *self._bands())

    # ------------------------------------------------------------------- warps

    def map_spatial_points(self, points, warp_embed, use_warp: bool = True,
                           extra_params=None):
        if self.config.use_warp and use_warp:
            return self.warp_field(points, warp_embed, extra_params)
        return points

    def map_hyper_points(self, points, hyper_embed,
                         hyper_point_override=None):
        """Hyper coordinates of (B, S, 3) points: the override broadcast over
        the samples, the per-sample embedding ``hyper_embed`` (the
        axis-aligned plane), or the bendy sheet's, or None without
        slicing."""
        if hyper_point_override is not None:
            return hyper_point_override[:, None, :].expand(
                *points.shape[:-1], hyper_point_override.shape[-1])
        if self.config.hyper_slice_method == 'axis_aligned_plane':
            return hyper_embed
        if self.config.hyper_slice_method == 'bendy_sheet':
            return self.hyper_sheet_mlp(points, hyper_embed).to(
                torch.promote_types(points.dtype, torch.float32))
        return None

    def apply_warp(self, points, warp_metadata, extra_params=None):
        """The warp field alone on (N, 3) points with (N, 1) metadata ids:
        the warped points (N, 3) (the background loss)."""
        return self.warp_field(points, self.warp_embed(warp_metadata),
                               extra_params)

    def map_points(self, points, warp_embed, hyper_embed,
                   use_warp: bool = True, hyper_point_override=None,
                   extra_params=None):
        """Warp the points and append their hyper coordinates."""
        if not use_warp:
            return points
        spatial = self.map_spatial_points(points, warp_embed, use_warp,
                                          extra_params)
        hyper = self.map_hyper_points(points, hyper_embed,
                                      hyper_point_override)
        if hyper is None:
            return spatial
        return torch.cat([spatial, hyper.to(spatial.dtype)], dim=-1)

    # ---------------------------------------------------------------- template

    def _encode_points(self, points, extra_params):
        """The template's encoding of (B, S, 3 + H) points, as the JAX
        model's ``query_template`` computes it."""
        cfg = self.config
        ep = extra_params or {}
        if cfg.use_original_embed:
            feats = [posenc_orig(points[..., :3], cfg.xyz_freq)]
            if points.shape[-1] > 3:
                feats.append(posenc_orig(points[..., 3:], cfg.hyper_freq))
        else:
            feats = [posenc(points[..., :3], cfg.spatial_point_min_deg,
                            cfg.spatial_point_max_deg, use_identity=True,
                            alpha=ep.get('nerf_alpha'))]
            if points.shape[-1] > 3:
                feats.append(posenc(points[..., 3:], cfg.hyper_point_min_deg,
                                    cfg.hyper_point_max_deg,
                                    alpha=ep.get('hyper_alpha')))
        return torch.cat(feats, dim=-1)

    def query_template(self, name: str, points, viewdirs, metadata,
                       stratified: bool = True, noise=None, generator=None,
                       extra_params=None, conds=None, tmpl_row=None):
        """The template on (B, S, 3 + H) mapped points: (rgb (B, S, 3),
        sigma (B, S)), sigmoid and softplus applied in fp32 after the sigma
        noise. CUDA tensors take the template kernel on the raw points (with
        the window row of the Nerfies encoding); CPU tensors the module on
        their encoding. ``conds`` and ``tmpl_row``: the (alpha, rgb)
        conditions of ``viewdirs`` and ``metadata`` and the template's window
        row, when the caller has built them (else built here from
        ``extra_params``)."""
        cfg = self.config
        if conds is None:
            conds = self.get_condition_inputs(viewdirs, metadata,
                                              extra_params)
        alpha_cond, rgb_cond = conds
        b, s, ch = points.shape
        mlp = self._template(name)
        tmpl = self.template_of(name)
        if ch != 3 + n_hyper(tmpl):
            raise ValueError(
                f'the template takes points of {3 + n_hyper(tmpl)} channels '
                f'([xyz | hyper]), got {ch}')
        if points.is_cuda:
            raw = F.pad(points.reshape(b * s, ch).float(),
                        (0, raw_pad(tmpl) - ch))
            if tmpl_row is None:
                tmpl_row = self._template_scales(extra_params, points.device)
            packed = fused_template(tmpl, raw,
                                    self._kernel_rgb(rgb_cond, b, points),
                                    tmpl_row, alpha_cond=alpha_cond)
            packed = packed.reshape(b, s, 4)
            raw_rgb, raw_alpha = packed[..., :3], packed[..., 3:]
        else:
            out = mlp(self._encode_points(points, extra_params), rgb_cond,
                      alpha_cond)
            raw_rgb, raw_alpha = out['rgb'].float(), out['alpha'].float()
        raw_alpha = noise_regularize(
            raw_alpha, cfg.noise_std, stratified,
            noise=None if noise is None else noise.reshape(raw_alpha.shape),
            generator=generator)
        return torch.sigmoid(raw_rgb), F.softplus(raw_alpha.squeeze(-1))

    def query_sigma(self, points, metadata_id, extra_params=None):
        """Template density at raw world points, without sigma noise: the
        warp, the hyper coordinates (the sheet's, or the plane's embedding)
        and the template's density, one sample per row, with the id's
        conditions (zero view directions, as the JAX model's).

        Args:
          points: (N, 3) world positions; metadata_id: (N, 1) integer ids;
          extra_params: the annealing alphas.

        Returns:
          (N,) densities.
        """
        cfg = self.config
        metadata = {k: metadata_id for k in METADATA_KEYS}
        warp_embed = hyper_embed = None
        if cfg.use_warp:
            warp_embed = self.encode_warp_embed(metadata)[:, None, :]
            if cfg.has_hyper_embed:
                hyper_embed = self.encode_hyper_embed(metadata)[:, None, :]
        warped = self.map_points(points[:, None, :], warp_embed, hyper_embed,
                                 use_warp=cfg.use_warp,
                                 extra_params=extra_params)
        _, sigma = self.query_template(
            'fine' if cfg.num_fine_samples > 0 else 'coarse', warped,
            torch.zeros_like(points), metadata, stratified=False,
            extra_params=extra_params)
        return sigma[:, 0]

    # --------------------------------------------------------------- rendering

    def _warp_scales(self, extra_params, device):
        """The level kernel's window row of the SE(3) / quaternion trunk at
        ``extra_params['warp_alpha']``; None without an alpha (the kernels
        then skip the multiplication: the same numbers as a row of ones) and
        for the translation warp, which has no window."""
        alpha = (extra_params or {}).get('warp_alpha')
        if alpha is None or self.config.warp_field_type == 'translation':
            return None
        return se3_encoding_scales(self.warp_field, alpha, device)

    def _fused_branch(self, use_warp: bool, return_points: bool,
                      metadata) -> bool:
        """Whether a level runs as the level kernel (the JAX model's gate,
        which admits either template encoding and either slicing)."""
        cfg = self.config
        return (use_warp and cfg.hyper_slice_method in ('bendy_sheet',
                                                        'axis_aligned_plane')
                and cfg.hyper_use_warp_embed
                and not cfg.hyper_sheet_use_residual and not return_points
                and metadata.get('hyper_point') is None)

    def _warp_jacobian_side_channel(self, out, points, warp_embed,
                                    extra_params, subsample: bool, u=None,
                                    generator=None) -> None:
        """Attach the elastic loss's warp Jacobian to a fused-branch result
        ``out`` (see the module docstring). ``u``: (B, K) uniforms of the
        subsample, drawn from ``generator`` when absent."""
        k = self.config.elastic_jacobian_samples
        if k > 0 and subsample:
            idx = weighted_sample_indices(out['weights'].detach(), k, u=u,
                                          generator=generator)
            points = torch.gather(points, 1, idx[..., None].expand(-1, -1, 3))
            w_sum = out['weights'].sum(-1, keepdim=True)
            out['warp_jacobian_weights'] = (w_sum / k).expand(idx.shape)
        # The embed is the same for a ray's samples: broadcast it after the
        # subsample.
        embed = warp_embed[:, None, :].expand(*points.shape[:-1],
                                              warp_embed.shape[-1])
        if self.config.warp_field_type == 'translation':
            embed = embed.detach()
        out['warp_jacobian'] = self.warp_field.jacobian(points, embed,
                                                        extra_params)

    def render_samples(self, name: str, z_vals, origins, directions,
                       viewdirs, metadata, use_warp: bool = True,
                       stratified: bool = True, render_opts=None,
                       return_points: bool = False, fine_u=None, noise=None,
                       generator=None, extra_params=None,
                       return_warp_jacobian: bool = False,
                       subsample: bool = False, jacobian_u=None,
                       conds=None, window_rows=None,
                       metadata_encoded: bool = False,
                       sample_at_infinity: Optional[bool] = None
                       ) -> Dict[str, torch.Tensor]:
        """Warp, template and compositing of one level at depths ``z_vals``
        (B, S). ``noise``: (B, S) standard-normal draws of the sigma noise,
        drawn from ``generator`` when absent. ``return_warp_jacobian`` adds
        the warp Jacobian, on the fused branch subsampled when ``subsample``
        (with the uniforms ``jacobian_u``). ``conds``: the (alpha, rgb)
        conditions of ``viewdirs`` and ``metadata``; ``window_rows``:
        ``window_rows(extra_params)`` (each built here when not given).
        ``metadata_encoded``: the metadata holds the embeddings,
        'encoded_warp' (the level kernel's, which the plane also takes as its
        hyper coordinates) and, on the per-module branch, 'encoded_hyper'.
        ``sample_at_infinity``: None takes the config's."""
        cfg = self.config
        if conds is None:
            conds = self.get_condition_inputs(viewdirs, metadata,
                                              extra_params, metadata_encoded)
        if sample_at_infinity is None:
            sample_at_infinity = cfg.use_sample_at_infinity
        alpha_cond, rgb_cond = conds
        if window_rows is None:
            window_rows = self.window_rows(extra_params, z_vals.device)
        points = origins[:, None, :] + z_vals[..., None] * directions[:, None,
                                                                      :]
        flags = dict(use_white_background=cfg.use_white_background,
                     sample_at_infinity=sample_at_infinity)
        if self._fused_branch(use_warp, return_points, metadata):
            warp_embed = (metadata['encoded_warp'] if metadata_encoded
                          else self.encode_warp_embed(metadata))
            packed = fused_level(
                self.level(name), z_vals, origins, directions, warp_embed,
                self._kernel_rgb(rgb_cond, z_vals.shape[0], z_vals),
                *window_rows, alpha_cond=alpha_cond)
            if not render_opts:
                # The kernel adds its noise input to raw sigma, so the
                # regularizer runs on zeros; it hands them back when off.
                zeros = torch.zeros_like(z_vals)
                noise = noise_regularize(zeros, cfg.noise_std, stratified,
                                         noise=noise, generator=generator)
                extra = {} if noise is zeros else {
                    'noise': noise.contiguous()}
                out = fused_composite(packed, z_vals, directions, fine_u,
                                      **flags, **extra)
            else:
                # Filtering needs the per-sample sigma: composite in tensor
                # code.
                packed = packed.reshape(*z_vals.shape, 4)
                raw_alpha = noise_regularize(packed[..., 3], cfg.noise_std,
                                             stratified, noise=noise,
                                             generator=generator)
                sigma = filter_sigma(points, F.softplus(raw_alpha),
                                     render_opts)
                out = volumetric_rendering(torch.sigmoid(packed[..., :3]),
                                           sigma, z_vals, directions, **flags)
            if return_warp_jacobian:
                self._warp_jacobian_side_channel(
                    out, points, warp_embed, extra_params, subsample,
                    jacobian_u, generator)
            return out

        # The per-module branch: embeddings broadcast over the samples.
        warp_embed = hyper_embed = None
        if use_warp:
            if metadata_encoded:
                warp_embed = metadata['encoded_warp']
                if cfg.has_hyper_embed:
                    hyper_embed = metadata['encoded_hyper']
            else:
                warp_embed = self.encode_warp_embed(metadata)
                if cfg.has_hyper_embed:
                    hyper_embed = self.encode_hyper_embed(metadata)

        def per_sample(e):
            return None if e is None else e[:, None, :].expand(
                *z_vals.shape, e.shape[-1])

        warped = self.map_points(
            points, per_sample(warp_embed), per_sample(hyper_embed),
            use_warp=use_warp,
            hyper_point_override=metadata.get('hyper_point'),
            extra_params=extra_params)
        rgb, sigma = self.query_template(name, warped, viewdirs, metadata,
                                         stratified, noise, generator,
                                         extra_params, conds, window_rows[1])
        sigma = filter_sigma(points, sigma, render_opts)
        out = {}
        if return_warp_jacobian and use_warp:
            out['warp_jacobian'] = self.warp_field.jacobian(
                points, per_sample(warp_embed), extra_params)
        if return_points:
            out['points'] = points
            out['warped_points'] = warped
        out.update(volumetric_rendering(rgb, sigma, z_vals, directions,
                                        **flags))
        if return_points:
            # The warped point each ray terminates at (median depth).
            index = compute_depth_index(out['weights'])
            out['med_points'] = torch.gather(
                warped, 1, index[:, None, None].expand(-1, 1,
                                                       warped.shape[-1]))
        return out

    def forward(self, rays_dict: Dict[str, Any], deterministic: bool = True,
                return_weights: bool = True,
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, torch.Tensor]] = None,
                use_warp: bool = True, return_points: bool = False,
                render_opts: Optional[Dict[str, Any]] = None,
                extra_params: Optional[Dict[str, Any]] = None,
                return_warp_jacobian: bool = False,
                window_rows=None,
                occupancy_grid: Optional[torch.Tensor] = None,
                near=None, far=None,
                use_sample_at_infinity: Optional[bool] = None,
                metadata_encoded: bool = False) -> Dict[str, Dict]:
        """Render a batch of rays.

        Args:
          rays_dict: ``ops.ray_dict.prepare_ray_dict`` output: origins,
            directions (B, 3), optional viewdirs, per-ray near / far (B,),
            metadata ids (B, 1), or (B, 3) to interpolate two codes; an
            optional metadata 'hyper_point' (B, H) overrides the hyper
            coordinates.
          deterministic: the render path (no stratified jitter, no sigma
            noise); False is the train step's forward.
          generator: source of the stochastic forward's draws, on the rays'
            device.
          draws: explicit draws instead: 't_rand' (B, S) uniforms of the
            coarse jitter, or with an occupancy grid 'coarse_u' (B, S)
            ascending uniforms of the grid's coarse draw in its place,
            'fine_u' (B, N) ascending uniforms, and
            'noise_coarse' (B, S) / 'noise_fine' (B, S + N) standard-normal
            draws of the sigma noise (``noise_std`` scales them here). A
            missing key is drawn.
          use_warp: False renders the template on the bare points (for a
            model whose template takes no hyper coordinates).
          return_points: also return per-sample 'points', 'warped_points'
            and per-ray 'med_points'.
          render_opts: ``filter_sigma`` options for the fine level
            ('dust_threshold', 'bounding_box').
          extra_params: the annealing alphas (see the module docstring;
            absent or None: no window).
          return_warp_jacobian: each level also returns 'warp_jacobian'
            (B, S or K, 3, 3) and, when subsampled, 'warp_jacobian_weights'
            (B, K) (see the module docstring).
          window_rows: ``window_rows(extra_params)``, when the caller has
            built them (a render at fixed alphas); else built here.
          occupancy_grid: a (G, G, G) density grid on the rays' device;
            with ``use_occupancy_grid`` the coarse depths come from it
            (``ops.occupancy.sample_occupancy_rays``), the coarse level
            draws no fine depths and the fine draw is ``sample_pdf`` on the
            coarse weights gated by the grid. Without a grid every
            configuration renders as it does without one, as in JAX.
          near / far: the depth range, a number or (B,), in place of the
            rays' own 'near' / 'far', which take the place of the config's.
          use_sample_at_infinity: in place of the config's, on the fine
            level; the coarse level keeps the config's, as the JAX model's
            does.
          metadata_encoded: the metadata holds each ray's embeddings in
            place of ids: 'encoded_warp' (B, glo_dim), 'encoded_hyper' (with
            separate tables) and 'encoded_nerf' (with ``use_nerf_embed``);
            the GLO tables are not read.

        Returns:
          {'coarse': {...}, 'fine': {...}} with per-ray rgb / depth /
          med_depth / acc (and weights when ``return_weights``).
        """
        cfg = self.config
        use_warp = cfg.use_warp and use_warp
        stratified = cfg.use_stratified_sampling and not deterministic
        draws = dict(draws or {})
        origins = rays_dict['origins'].contiguous()
        directions = rays_dict['directions'].contiguous()
        metadata = rays_dict.get('metadata', {})
        viewdirs = rays_dict.get('viewdirs')
        if viewdirs is None:
            viewdirs = directions  # unnormalised, as the JAX model does
        if near is None:
            near = rays_dict.get('near', cfg.near)
        if far is None:
            far = rays_dict.get('far', cfg.far)
        if use_sample_at_infinity is None:
            use_sample_at_infinity = cfg.use_sample_at_infinity
        n_rays = origins.shape[0]

        grid_on = cfg.use_occupancy_grid and occupancy_grid is not None
        if grid_on:
            z_vals, _ = sample_occupancy_rays(
                origins, directions, occupancy_grid, config_bbox(cfg),
                cfg.num_coarse_samples, near, far, cfg.occupancy_probes,
                stratified, cfg.occupancy_floor,
                u=draws.get('coarse_u') if stratified else None,
                generator=generator)
        else:
            z_vals, _ = sample_along_rays(origins, directions,
                                          cfg.num_coarse_samples, near, far,
                                          stratified, cfg.use_linear_disparity,
                                          t_rand=draws.get('t_rand'),
                                          generator=generator)
        z_vals = z_vals.contiguous()
        n_fine = cfg.num_fine_samples
        fine_u = None
        if n_fine and stratified:
            fine_u = draws.get('fine_u')
            if fine_u is None:
                fine_u = sorted_uniform(n_rays, n_fine, generator,
                                        z_vals.dtype, z_vals.device)
            fine_u = fine_u.contiguous()
        elif n_fine:
            fine_u = torch.linspace(0.0, 1.0, n_fine, dtype=z_vals.dtype,
                                    device=z_vals.device)
            fine_u = fine_u.expand(n_rays, n_fine).contiguous()

        if window_rows is None:
            window_rows = self.window_rows(extra_params, origins.device)
        common = dict(use_warp=use_warp, stratified=stratified,
                      return_points=return_points, generator=generator,
                      extra_params=extra_params,
                      return_warp_jacobian=return_warp_jacobian,
                      subsample=not deterministic,
                      conds=self.get_condition_inputs(viewdirs, metadata,
                                                      extra_params,
                                                      metadata_encoded),
                      window_rows=window_rows,
                      metadata_encoded=metadata_encoded)
        # The compositing kernel draws the fine depths itself, except where
        # the fine level filters sigma or the grid gates the draw: then
        # ``sample_pdf`` does below.
        coarse = self.render_samples(
            'coarse', z_vals, origins, directions, viewdirs, metadata,
            fine_u=None if render_opts or grid_on else fine_u,
            noise=draws.get('noise_coarse'),
            jacobian_u=draws.get('jacobian_u_coarse'),
            sample_at_infinity=cfg.use_sample_at_infinity, **common)
        out = {'coarse': coarse}
        if n_fine:
            z_union = coarse.pop('z_union', None)
            if z_union is None:
                z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
                weights = coarse['weights'][..., 1:-1]
                if grid_on:
                    weights = gate_fine_weights(
                        occupancy_grid, origins, directions,
                        z_vals[..., 1:-1], weights, config_bbox(cfg),
                        cfg.occupancy_floor)
                z_union, _ = sample_pdf(
                    z_mid, weights, origins, directions, z_vals, n_fine,
                    stratified, u=fine_u)
                z_union = z_union.contiguous()
            out['fine'] = self.render_samples(
                'fine', z_union, origins, directions, viewdirs, metadata,
                render_opts=render_opts, noise=draws.get('noise_fine'),
                jacobian_u=draws.get('jacobian_u_fine'),
                sample_at_infinity=use_sample_at_infinity, **common)
        if not return_weights:
            for res in out.values():
                res.pop('weights', None)
        return out
