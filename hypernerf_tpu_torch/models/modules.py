"""Neural modules (port of ``hypernerf_tpu/models/modules.py``).

Module and parameter names follow the flax tree (``hidden_{i}``, ``logit``,
``trunk``, ``bottleneck``, ``alpha_head``, ``rgb_branch``, ``mlp``,
``embed``), so a flax path maps onto a state-dict key by renaming alone
(``convert.params_from_jax``). Initializers draw from the same
distributions as the flax ones.

Numerics are those of the fused level kernel at every compute dtype, so
these modules are also the kernels' plain versions: the input of each MLP
is rounded to the compute dtype, every product takes compute-dtype operands
with fp32 accumulation, biases are held in the compute dtype and added in
fp32, a hidden layer applies ReLU before rounding its output to the compute
dtype, and the heads stay fp32. At ``float32`` this is a plain fp32 MLP.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from hypernerf_tpu_torch.ops.posenc import posenc_orig, posenc_orig_channels


def torch_dtype(name: str) -> torch.dtype:
    """'bfloat16' / 'float32' / 'float64' -> the torch dtype."""
    return {'bfloat16': torch.bfloat16, 'float32': torch.float32,
            'float64': torch.float64}[name]


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype,
          relu: bool = False) -> torch.Tensor:
    """``[relu](x @ W^T + b)`` with compute-dtype operands and bias, summed
    in at least fp32. A ReLU layer rounds its output to ``dtype``; a linear
    layer returns the fp32 sum."""
    acc = torch.promote_types(dtype, torch.float32)
    out = F.linear(x.to(dtype).to(acc), layer.weight.to(dtype).to(acc),
                   layer.bias.to(dtype).to(acc))
    if relu:
        return torch.relu(out).to(dtype)
    return out


def xavier_normal_(w: torch.Tensor) -> torch.Tensor:
    """flax ``xavier_normal``: a normal truncated at two deviations, scaled
    so its std is sqrt(2 / (fan_in + fan_out))."""
    fan_out, fan_in = w.shape
    std = math.sqrt(2.0 / (fan_in + fan_out)) / .87962566103423978
    return nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std)


class MLP(nn.Module):
    """ReLU MLP with the skip concatenated AFTER layer i's activation.

    ``output_relu`` gives the logit layer a ReLU (the template trunk);
    otherwise the logit is linear and returned in fp32. Biases keep torch's
    default U(+-1/sqrt(fan_in)), the flax package's ``torch_linear_bias``,
    unless ``torch_default_bias`` is off: then they start at zero (the SE(3)
    field's w and v heads, whose warp must start at the identity). With
    ``depth=0`` the MLP is its logit layer alone.
    """

    def __init__(self, in_ch: int, out_ch: int, depth: int = 8,
                 width: int = 256, skips: Sequence[int] = (4,),
                 hidden_init: Callable = nn.init.xavier_uniform_,
                 output_init: Optional[Callable] = None,
                 output_relu: bool = False, dtype=torch.float32,
                 torch_default_bias: bool = True):
        super().__init__()
        self.depth = depth
        self.skips = tuple(skips)
        self.output_relu = output_relu
        self.dtype = dtype
        ch = in_ch
        for i in range(depth):
            layer = nn.Linear(ch, width)
            hidden_init(layer.weight)
            self.add_module(f'hidden_{i}', layer)
            ch = width + (in_ch if i in self.skips else 0)
        self.logit = nn.Linear(ch, out_ch)
        (output_init or hidden_init)(self.logit.weight)
        if not torch_default_bias:
            for m in self.children():
                nn.init.zeros_(m.bias)

    def hidden(self, i: int) -> nn.Linear:
        return getattr(self, f'hidden_{i}')

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inputs = x.to(self.dtype)
        h = inputs
        for i in range(self.depth):
            h = dense(h, self.hidden(i), self.dtype, relu=True)
            if i in self.skips:
                h = torch.cat([h, inputs], dim=-1)
        return dense(h, self.logit, self.dtype, relu=self.output_relu)


def field_kernel(mlp: MLP, n_freq: int, points: torch.Tensor,
                 embed: torch.Tensor) -> torch.Tensor:
    """A field MLP on CUDA tensors through its kernel: points (..., 3) and
    per-sample embed (..., E) -> (..., out_ch) fp32. One ``cat`` makes the
    kernel's raw rows, so a broadcast embedding is materialised once and its
    gradient is summed per ray by autograd."""
    # The kernels' wrappers import this module: import them at call time.
    from hypernerf_tpu_torch.kernels.fused_field import fused_field
    raw = torch.cat([points, embed.to(points.dtype)], dim=-1)
    out = fused_field(mlp, n_freq, raw.reshape(-1, raw.shape[-1]).float())
    return out.reshape(*points.shape[:-1], out.shape[-1])


class GLOEmbed(nn.Module):
    """Per-frame latent codes, init normal(0.1 / features); ids are clipped
    into range as the JAX package does."""

    def __init__(self, num_embeddings: int, features: int = 8):
        super().__init__()
        self.num_embeddings = num_embeddings
        self.embed = nn.Embedding(num_embeddings, features)
        nn.init.normal_(self.embed.weight, std=0.1 / features)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        if ids.dim() and ids.shape[-1] == 1:
            ids = ids.squeeze(-1)
        idx = torch.clamp(ids.to(torch.int64), 0, self.num_embeddings - 1)
        return self.embed(idx)


class NerfMLP(nn.Module):
    """Template: trunk (ReLU logit) -> bottleneck -> alpha head, and the
    rgb branch on [bottleneck | per-ray rgb condition].

    Returns raw fp32 {'rgb': (..., 3) logits, 'alpha': (..., 1)}.
    """

    def __init__(self, in_ch: int, rgb_cond_ch: int, trunk_depth: int = 8,
                 trunk_width: int = 256, rgb_branch_depth: int = 4,
                 rgb_branch_width: int = 128, rgb_channels: int = 3,
                 alpha_channels: int = 1, skips: Sequence[int] = (4,),
                 dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.trunk = MLP(in_ch, trunk_width, trunk_depth, trunk_width, skips,
                         output_relu=True, dtype=dtype)
        # torch's default Linear init is the reference's bare bottleneck.
        self.bottleneck = nn.Linear(trunk_width, trunk_width // 2)
        self.alpha_head = nn.Linear(trunk_width // 2, alpha_channels)
        nn.init.xavier_uniform_(self.alpha_head.weight)
        self.rgb_branch = MLP(trunk_width // 2 + rgb_cond_ch, rgb_channels,
                              rgb_branch_depth, rgb_branch_width, skips,
                              dtype=dtype)

    def forward(self, x: torch.Tensor, rgb_condition: torch.Tensor) -> dict:
        """x: (..., S, F) encoded samples; rgb_condition: per-ray (..., C)
        (broadcast over S) or per-sample (..., S, C)."""
        trunk = self.trunk(x)
        bneck = dense(trunk, self.bottleneck, self.dtype).to(self.dtype)
        alpha = dense(bneck, self.alpha_head, self.dtype)
        c = rgb_condition
        if c.dim() == x.dim() - 1:
            c = c[..., None, :]
        c = c.to(self.dtype).expand(*x.shape[:-1], c.shape[-1])
        rgb = self.rgb_branch(torch.cat([bneck, c], dim=-1))
        return {'rgb': rgb, 'alpha': alpha}


class HyperSheetMLP(nn.Module):
    """Bendy sheet: posenc_orig(points, n_freq) ++ embed -> MLP -> hyper
    coordinates (fp32), output init normal(1e-5)."""

    def __init__(self, embed_ch: int, out_ch: int = 4, depth: int = 6,
                 width: int = 64, n_freq: int = 7,
                 skips: Sequence[int] = (4,), use_residual: bool = False,
                 dtype=torch.float32):
        super().__init__()
        self.n_freq = n_freq
        self.use_residual = use_residual
        self.mlp = MLP(posenc_orig_channels(3, n_freq) + embed_ch, out_ch,
                       depth, width, skips,
                       output_init=lambda w: nn.init.normal_(w, std=1e-5),
                       dtype=dtype)

    def forward(self, points: torch.Tensor, embed: torch.Tensor):
        """points (..., 3), embed (..., E) per sample -> (..., out_ch)."""
        if points.is_cuda:
            out = field_kernel(self.mlp, self.n_freq, points, embed)
        else:
            inputs = torch.cat([posenc_orig(points, self.n_freq),
                                embed.to(points.dtype)], dim=-1)
            out = self.mlp(inputs)
        return out + embed if self.use_residual else out
