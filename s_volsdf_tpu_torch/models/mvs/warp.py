"""Homography warping for plane-sweep cost volumes (counterpart of
s_volsdf_tpu/models/mvs/warp.py:26-80): the CasMVSNet and UCSNet
convention (align_corners=False, zeros padding, no behind-camera mask)
and TransMVSNet's (align_corners=True, and grid points of hypotheses
behind the source camera set to -99, i.e. sampled as zeros).

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


def sample_grid(src_fea: torch.Tensor, grid: torch.Tensor,
                align_corners: bool = False) -> torch.Tensor:
    """Bilinear sample (C, H, W) features at a (D, H, W, 2) grid with
    zeros padding. Returns (C, D, H, W)."""
    C = src_fea.shape[0]
    D, H, W = grid.shape[:3]
    out = F.grid_sample(src_fea[None], grid.reshape(1, D * H, W, 2),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=align_corners)
    return out.reshape(C, D, H, W)


def homo_warping(src_fea: torch.Tensor, src_proj: torch.Tensor,
                 ref_proj: torch.Tensor, depth_values: torch.Tensor,
                 align_corners: bool = False,
                 mask_behind: bool = False) -> torch.Tensor:
    """Warp source features (C, H, W) onto the reference view's depth
    planes depth_values (D,) or (D, H, W). Returns (C, D, H, W).
    TransMVSNet's variant: align_corners=True, mask_behind=True."""
    _, H, W = src_fea.shape
    grid, valid_z = _proj_grid(src_proj, ref_proj, depth_values, H, W)
    if mask_behind:
        grid = torch.where(valid_z[..., None], grid, -99.0)
    return sample_grid(src_fea, grid, align_corners)
