"""Chunked depth render, the cascade-feedback path (counterpart of
s_volsdf_tpu/engine/render.py:66-139).

Every SDF evaluation here — the sampler's sweeps and the final one over
the chosen samples — goes through `models.network.sampler_sdf_fn`: the
CUDA kernel `ops.fused_sdf.fused_sdf_values` on a CUDA device, in the
mode the model config's precision names, for a config in the kernel's
family; the plain MLP otherwise. The render's float32 arithmetic runs
in full float32 on the card (`utils.device.full_float32`).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.config import ModelConfig, check_model_ported
from s_volsdf_tpu_torch.models.density import get_beta, laplace_density
from s_volsdf_tpu_torch.models.network import (VolSDFParams, sampler_sdf_fn,
                                               volume_rendering)
from s_volsdf_tpu_torch.models.sampler import error_bound_sample
from s_volsdf_tpu_torch.utils.cameras import (depth_scale_factor,
                                              get_camera_params)
from s_volsdf_tpu_torch.utils.device import full_float32


def _depth_chunk(params: VolSDFParams, uv, pose, intrinsics, gen, sdf_fn, *,
                 cfg: ModelConfig, fast: int) -> Dict[str, torch.Tensor]:
    """Depth and accumulated weight of uv (B, N, 2); skips the radiance
    MLP and the normals. sdf_fn: `sampler_sdf_fn` of the params."""
    ray_dirs, cam_loc = get_camera_params(uv, pose, intrinsics)
    depth_scale = depth_scale_factor(uv, intrinsics)
    B, N, _ = ray_dirs.shape
    R = B * N
    ray_dirs = ray_dirs.reshape(R, 3)
    cam_loc = cam_loc[:, None, :].expand(B, N, 3).reshape(R, 3)
    depth_scale = depth_scale.reshape(R, 1)

    beta0 = get_beta(params.density, cfg.density.beta_min)
    n_iters = fast if fast >= 0 else cfg.sampler.max_total_iters
    s_out = error_bound_sample(
        gen, cfg.sampler, ray_dirs, cam_loc, sdf_fn, beta0,
        n_iters=n_iters, training=False,
        scene_bounding_sphere=cfg.scene_bounding_sphere)
    z_vals = s_out.z_vals
    pts = cam_loc[:, None, :] + z_vals[..., None] * ray_dirs[:, None, :]
    sdf = sdf_fn(pts.reshape(-1, 3)).reshape(z_vals.shape)
    weights = volume_rendering(z_vals, laplace_density(sdf, beta0))
    depth = torch.sum(weights * z_vals, dim=1, keepdim=True) / (
        torch.sum(weights, dim=1, keepdim=True) + 1e-8)
    return {"depth_values": depth * depth_scale,
            "acc": torch.sum(weights, dim=-1)}


def render_depth(params: VolSDFParams, cfg: ModelConfig, pose, intrinsics,
                 img_res: Tuple[int, int], *, chunk: int = 16384,
                 fast: int = -1, gen: Optional[torch.Generator] = None,
                 device=None) -> Dict[str, np.ndarray]:
    """Depth-only full-image render in fixed chunks of `chunk` pixels
    (the last one zero-padded). pose/intrinsics: (4, 4) numpy. Returns
    host maps depth (H, W) and acc (H, W)."""
    check_model_ported(cfg)
    device = torch.device(device) if device is not None \
        else next(params.parameters()).device
    gen = gen if gen is not None \
        else torch.Generator(device=device).manual_seed(0)
    H, W = img_res
    ys, xs = np.mgrid[0:H, 0:W]
    uv = np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32)
    n = uv.shape[0]
    uv = np.concatenate([uv, np.zeros(((-n) % chunk, 2), np.float32)], axis=0)
    uv = torch.as_tensor(uv, device=device)
    pose_b = torch.as_tensor(np.asarray(pose, np.float32), device=device)[None]
    intr_b = torch.as_tensor(np.asarray(intrinsics, np.float32),
                             device=device)[None]
    bounding = 0.0 if (cfg.white_bkgd or cfg.with_background) \
        else cfg.scene_bounding_sphere
    sdf_fn = sampler_sdf_fn(params, cfg, bounding)   # route, pack: per render
    depth, acc = [], []
    with torch.no_grad(), full_float32():
        for i in range(0, uv.shape[0], chunk):
            o = _depth_chunk(params, uv[i:i + chunk][None], pose_b, intr_b,
                             gen, sdf_fn, cfg=cfg, fast=fast)
            depth.append(o["depth_values"].reshape(chunk))
            acc.append(o["acc"].reshape(chunk))
    depth = torch.cat(depth)[:n].reshape(H, W).cpu().numpy()
    acc = torch.cat(acc)[:n].reshape(H, W).cpu().numpy()
    return {"depth": depth, "acc": acc}
