"""Original-NeRF positional encoding (port of ``hypernerf_tpu/ops/posenc.py``).

Block layout ``[x | sin bands | cos bands]`` with band k of channel c at
column ``k * C + c`` — the JAX package's layout, so weights move across
without a permutation. The backward (an analytic VJP in the JAX package)
comes with the training slice; autograd covers it until then.
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
