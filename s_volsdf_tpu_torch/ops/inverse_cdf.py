"""Inverse-CDF sampling (counterpart of
s_volsdf_tpu/ops/inverse_cdf.py:35-100).

The JAX package writes the lookup as masked max/min reductions, a TPU
gather workaround that is bit-identical to searchsorted + gather on
sorted bins. The port uses `torch.searchsorted` + `gather`: the masked
form would materialise an (R, N, K) mask, 1.3 G elements at the eval
render's shapes.

Preconditions, as in the JAX package: cdf non-decreasing per ray with
cdf[..., 0] == 0, bins non-decreasing per ray, u >= 0.
"""

from __future__ import annotations

import torch


def sample_pdf_from_cdf(bins: torch.Tensor, cdf: torch.Tensor,
                        u: torch.Tensor) -> torch.Tensor:
    """bins, cdf: (R, K); u: (R, N) quantiles in [0, 1]. Returns (R, N)
    samples, linearly interpolated within CDF segments."""
    K = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=K - 1)

    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)


def pdf_to_cdf(pdf: torch.Tensor) -> torch.Tensor:
    """Normalise a per-interval pdf (R, K-1); return the CDF with a
    leading zero, (R, K)."""
    pdf = pdf / torch.sum(pdf, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
