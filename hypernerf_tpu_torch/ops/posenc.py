"""Positional encodings (port of ``hypernerf_tpu/ops/posenc.py``): the
original-NeRF ``posenc_orig`` and the Nerfies ``posenc`` with its windowed
annealing.

Block layout ``[x? | sin bands | cos bands]`` with band k of channel c at
column ``k * C + c`` — the JAX package's layout, so weights move across
without a permutation. The backward (an analytic VJP in the JAX package) is
autograd's here.
"""

from __future__ import annotations

import torch


def posenc_orig_channels(in_ch: int, n_freqs: int) -> int:
    """Output channels of ``posenc_orig`` (identity + sin/cos per band)."""
    return in_ch * (1 + 2 * n_freqs)


def posenc_orig(x: torch.Tensor, n_freqs: int,
                log_scale: bool = True) -> torch.Tensor:
    """(..., C) -> (..., C * (1 + 2 * n_freqs)) as [x | sin | cos].

    Bands are 2^k (``log_scale``) or linspace(0, n_freqs - 1).
    """
    if n_freqs == 0:
        return x
    if log_scale:
        freqs = 2.0 ** torch.arange(n_freqs, dtype=x.dtype, device=x.device)
    else:
        freqs = torch.linspace(0.0, n_freqs - 1, n_freqs, dtype=x.dtype,
                               device=x.device)
    xb = (x[..., None, :] * freqs[:, None]).reshape(
        *x.shape[:-1], n_freqs * x.shape[-1])
    return torch.cat([x, torch.sin(xb), torch.cos(xb)], dim=-1)


def posenc_channels(in_ch: int, min_deg: int, max_deg: int,
                    use_identity: bool = False) -> int:
    """Output channels of the Nerfies-style ``posenc``."""
    return in_ch * (2 * (max_deg - min_deg) + (1 if use_identity else 0))


def posenc_window(min_deg: int, max_deg: int, alpha, device=None):
    """Hann window easing in the bands ``min_deg .. max_deg - 1`` as
    ``alpha`` grows: band k is fully on once ``alpha >= k + 1`` and off while
    ``alpha <= k``. Returns (max_deg - min_deg,) fp32 weights in [0, 1]."""
    bands = torch.arange(min_deg, max_deg, dtype=torch.float32, device=device)
    alpha = torch.as_tensor(alpha, dtype=torch.float32, device=device)
    x = torch.clamp(alpha - bands, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(torch.pi * x))


def posenc(x: torch.Tensor, min_deg: int, max_deg: int,
           use_identity: bool = False, alpha=None) -> torch.Tensor:
    """Nerfies-style encoding: sinusoids scaled by ``2^[min_deg, max_deg)``,
    each band weighted by ``posenc_window`` when ``alpha`` is given (a
    schedule constant: no gradient reaches it).

    (..., C) -> (..., C * 2 * (max_deg - min_deg) [+ C]) as
    [x? | sin bands | cos bands].
    """
    c = x.shape[-1]
    scales = 2.0 ** torch.arange(min_deg, max_deg, dtype=x.dtype,
                                 device=x.device)
    xb = (x[..., None, :] * scales[:, None]).reshape(*x.shape[:-1],
                                                     scales.shape[0] * c)
    sin_part, cos_part = torch.sin(xb), torch.cos(xb)
    if alpha is not None:
        window = posenc_window(min_deg, max_deg, alpha, x.device).detach()
        window = window.repeat_interleave(c).to(x.dtype)
        sin_part, cos_part = sin_part * window, cos_part * window
    return torch.cat(([x] if use_identity else []) + [sin_part, cos_part],
                     dim=-1)
