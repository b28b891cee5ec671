"""Depth-hypothesis generators for the MVS cascade (counterpart of
s_volsdf_tpu/models/mvs/hypotheses.py:16-74): linear range sampling from
a (D0,) global range or a per-pixel window around the current depth,
the inverse-depth variant for unbounded scenes, and UCSNet's
uncertainty-aware slab."""

from __future__ import annotations

from typing import Optional

import torch


def cur_depth_range_samples(cur_depth: torch.Tensor, ndepth: int,
                            depth_interval_pixel) -> torch.Tensor:
    """Per-pixel window [d - D/2*i, d + D/2*i]. (H, W) -> (D, H, W)."""
    cur_depth_min = cur_depth - ndepth / 2 * depth_interval_pixel
    cur_depth_max = cur_depth + ndepth / 2 * depth_interval_pixel
    new_interval = (cur_depth_max - cur_depth_min) / (ndepth - 1)
    steps = torch.arange(ndepth, dtype=cur_depth.dtype,
                         device=cur_depth.device)[:, None, None]
    return cur_depth_min[None] + steps * new_interval[None]


def depth_range_samples(cur_depth: torch.Tensor, ndepth: int,
                        depth_interval_pixel, shape) -> torch.Tensor:
    """The first stage's linear span of a (D0,) range, else the
    per-pixel window. Returns (D, H, W)."""
    H, W = shape
    if cur_depth.ndim == 1:
        dmin, dmax = cur_depth[0], cur_depth[-1]
        new_interval = (dmax - dmin) / (ndepth - 1)
        steps = torch.arange(ndepth, dtype=cur_depth.dtype,
                             device=cur_depth.device)
        d = dmin + steps * new_interval                     # (D,)
        return d[:, None, None].expand(ndepth, H, W)
    return cur_depth_range_samples(cur_depth, ndepth, depth_interval_pixel)


def depth_range_samples_inverse(cur_depth: torch.Tensor, ndepth: int,
                                depth_interval_pixel, shape) -> torch.Tensor:
    """The first stage samples uniformly in 1/d; later stages keep the
    linear window."""
    H, W = shape
    if cur_depth.ndim == 1:
        dmin, dmax = cur_depth[0], cur_depth[-1]
        z = torch.linspace(0.0, 1.0, ndepth, dtype=cur_depth.dtype,
                           device=cur_depth.device)
        d = 1.0 / (1.0 / dmin * (1.0 - z) + 1.0 / dmax * z)  # (D,)
        return d[:, None, None].expand(ndepth, H, W)
    return cur_depth_range_samples(cur_depth, ndepth, depth_interval_pixel)


def uncertainty_aware_samples(cur_depth: torch.Tensor,
                              exp_var: Optional[torch.Tensor], ndepth: int,
                              shape, inverse_depth: bool = False,
                              eps: float = 1e-12) -> torch.Tensor:
    """UCSNet's hypotheses: the first stage's span of a (D0,) range
    (uniform in 1/d with `inverse_depth`), else the per-pixel window
    [d - min(d, sigma), d + sigma], sigma = `exp_var` (H, W), the
    previous stage's lamb-scaled predicted std. Returns (D, H, W)."""
    H, W = shape
    if cur_depth.ndim == 1:
        dmin, dmax = cur_depth[0], cur_depth[-1]
        if inverse_depth:
            z = torch.linspace(0.0, 1.0, ndepth, dtype=cur_depth.dtype,
                               device=cur_depth.device)
            d = 1.0 / (1.0 / dmin * (1.0 - z) + 1.0 / dmax * z)
        else:
            new_interval = (dmax - dmin) / (ndepth - 1)
            d = dmin + torch.arange(ndepth, dtype=cur_depth.dtype,
                                    device=cur_depth.device) * new_interval
        return d[:, None, None].expand(ndepth, H, W)
    low_bound = -torch.minimum(cur_depth, exp_var)
    high_bound = exp_var
    step = (high_bound - low_bound) / (float(ndepth) - 1)
    steps = torch.arange(ndepth, dtype=cur_depth.dtype,
                         device=cur_depth.device)[:, None, None]
    return cur_depth[None] + low_bound[None] + steps * step[None] + eps
