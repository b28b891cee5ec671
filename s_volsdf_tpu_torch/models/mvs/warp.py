"""Homography warping for plane-sweep cost volumes, CasMVSNet convention
(counterpart of s_volsdf_tpu/models/mvs/warp.py:26-80 with
align_corners=False, zeros padding and no behind-camera mask; the
TransMVSNet variant is not ported).

The sampling grid is computed closed-form per (depth, pixel) and the
source features are sampled with `F.grid_sample`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _proj_grid(src_proj: torch.Tensor, ref_proj: torch.Tensor,
               depth_values: torch.Tensor, height: int, width: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalized (x, y) sampling grid + positive-depth mask.

    src_proj/ref_proj: (4, 4) stage projections (K@[R|t]); depth_values:
    (D, H, W) or (D,) hypothesis depths in the reference view. Returns
    grid (D, H, W, 2) and the z > 0 mask (D, H, W)."""
    proj = src_proj @ torch.linalg.inv(ref_proj)
    rot = proj[:3, :3]
    trans = proj[:3, 3]
    dev, dt = src_proj.device, src_proj.dtype
    y, x = torch.meshgrid(torch.arange(height, dtype=dt, device=dev),
                          torch.arange(width, dtype=dt, device=dev),
                          indexing="ij")
    xyz = torch.stack([x, y, torch.ones_like(x)], dim=-1)   # (H, W, 3)
    rot_xyz = xyz @ rot.T                                     # (H, W, 3)
    depth = depth_values[:, None, None] if depth_values.ndim == 1 \
        else depth_values                                     # (D, H, W)
    proj_xyz = rot_xyz[None] * depth[..., None] + trans       # (D, H, W, 3)
    z = proj_xyz[..., 2]
    xy = proj_xyz[..., :2] / z[..., None]
    gx = xy[..., 0] / ((width - 1) / 2.0) - 1.0
    gy = xy[..., 1] / ((height - 1) / 2.0) - 1.0
    return torch.stack([gx, gy], dim=-1), z > 1e-6


def sample_grid(src_fea: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (C, H, W) features at a (D, H, W, 2) grid,
    align_corners=False and zeros padding. Returns (C, D, H, W)."""
    C = src_fea.shape[0]
    D, H, W = grid.shape[:3]
    out = F.grid_sample(src_fea[None], grid.reshape(1, D * H, W, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.reshape(C, D, H, W)


def homo_warping(src_fea: torch.Tensor, src_proj: torch.Tensor,
                 ref_proj: torch.Tensor,
                 depth_values: torch.Tensor) -> torch.Tensor:
    """Warp source features (C, H, W) onto the reference view's depth
    planes depth_values (D,) or (D, H, W). Returns (C, D, H, W)."""
    _, H, W = src_fea.shape
    grid, _ = _proj_grid(src_proj, ref_proj, depth_values, H, W)
    return sample_grid(src_fea, grid)
