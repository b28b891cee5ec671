"""Chunked full-image renders (counterpart of
s_volsdf_tpu/engine/render.py:52-209): the depth-only render of the
cascade feedback (`render_depth`) and the eval render with rgb, depth,
normal and acc (`render_image`).

The sampler's sweeps go through `models.network.sampler_sdf_fn`, made
once per image (one weight pack): the CUDA kernel
`ops.fused_sdf.fused_sdf_values` on a CUDA device, in the mode the model
config's precision names, for a config in the kernel's family; the
plain MLP otherwise. `render_depth` takes its final SDF over the chosen
samples through the same function; `render_image` takes it from the
plain MLP with its spatial gradient (`render_rays(training=False)`),
since the normals need that gradient and the radiance MLP the
features, and frees that graph with each chunk. The renders' float32
arithmetic runs in full float32 on the card
(`utils.device.full_float32`). With a background model
(model.with_background) the sweeps are unclamped (bounding sphere 0),
`render_depth` drops the sampler's last column (the sphere's exit), and
`render_image` renders through `models.network_bg.render_rays_bg` with
the nearest training view's directions.

With `group` (parallel.mesh.eval_group; the JAX package's `mesh=`) each
chunk's rays are split over the group's ranks, each rank renders its
rows, and the rows are gathered, so every rank returns the whole image.
The sampler's global early exit tests every rank's rows of the chunk
(`ray_group`), so the sharded render takes the unsharded one's
iterations; the eval sampler's only draw, the eikonal index, feeds no
output. A chunk with fewer rays than ranks is rendered whole on every
rank.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.config import ModelConfig, check_model_ported
from s_volsdf_tpu_torch.models.density import get_beta, laplace_density
from s_volsdf_tpu_torch.models.network import (VolSDFParams, render_rays,
                                               sampler_sdf_fn,
                                               volume_rendering)
from s_volsdf_tpu_torch.models.network_bg import render_rays_bg
from s_volsdf_tpu_torch.models.sampler import error_bound_sample
from s_volsdf_tpu_torch.utils.cameras import (depth_scale_factor,
                                              get_camera_params)
from s_volsdf_tpu_torch.utils.device import full_float32


def _rows_of(fn, uv: torch.Tensor, group) -> Dict[str, torch.Tensor]:
    """fn(uv rows, ray_group) -> {name: (rows, ...)} over the whole chunk
    of rays uv (n, 2), as (n, C) tensors: with `group`, over this rank's
    rows, the ranks' rows gathered; without, over all n rows."""
    n = uv.shape[0]
    if group is None or n < group.size:
        return {k: v.reshape(n, -1) for k, v in fn(uv, None).items()}
    start, stop = group.rows(n)
    out = fn(uv[start:stop], group)
    return {k: group.gather_rows(v.reshape(stop - start, -1), start, n)
            for k, v in out.items()}


def _depth_chunk(params: VolSDFParams, uv, pose, intrinsics, gen, sdf_fn, *,
                 cfg: ModelConfig, fast: int,
                 ray_group=None) -> Dict[str, torch.Tensor]:
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
        scene_bounding_sphere=cfg.scene_bounding_sphere, ray_group=ray_group)
    z_vals = s_out.z_vals
    if cfg.with_background:
        z_vals = z_vals[:, :-1]     # the last column is the sphere's exit
    pts = cam_loc[:, None, :] + z_vals[..., None] * ray_dirs[:, None, :]
    sdf = sdf_fn(pts.reshape(-1, 3)).reshape(z_vals.shape)
    # With a background model the last sample (1e10 long) reads the
    # density's tail, where JAX's expm1 rounds one unit above torch's.
    weights = volume_rendering(z_vals, laplace_density(
        sdf, beta0, exact_tail=cfg.with_background))
    depth = torch.sum(weights * z_vals, dim=1, keepdim=True) / (
        torch.sum(weights, dim=1, keepdim=True) + 1e-8)
    return {"depth_values": depth * depth_scale,
            "acc": torch.sum(weights, dim=-1)}


def render_depth(params: VolSDFParams, cfg: ModelConfig, pose, intrinsics,
                 img_res: Tuple[int, int], *, chunk: int = 16384,
                 fast: int = -1, gen: Optional[torch.Generator] = None,
                 device=None, group=None) -> Dict[str, np.ndarray]:
    """Depth-only full-image render in fixed chunks of `chunk` pixels
    (the last one zero-padded). pose/intrinsics: (4, 4) numpy. Returns
    host maps depth (H, W) and acc (H, W). `group`: the ranks that share
    each chunk (module docstring)."""
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
            o = _rows_of(lambda u, g: _depth_chunk(
                params, u[None], pose_b, intr_b, gen, sdf_fn, cfg=cfg,
                fast=fast, ray_group=g), uv[i:i + chunk], group)
            depth.append(o["depth_values"].reshape(chunk))
            acc.append(o["acc"].reshape(chunk))
    depth = torch.cat(depth)[:n].reshape(H, W).cpu().numpy()
    acc = torch.cat(acc)[:n].reshape(H, W).cpu().numpy()
    return {"depth": depth, "acc": acc}


def render_image(params: VolSDFParams, cfg: ModelConfig, pose, intrinsics,
                 img_res: Tuple[int, int], *, chunk: int = 16384,
                 fast: int = -1, gen: Optional[torch.Generator] = None,
                 device=None, near_pose=None,
                 group=None) -> Dict[str, np.ndarray]:
    """Full-image render in chunks of `chunk` rays (the last one
    ragged; rays are independent, so the chunk does not change the
    values). pose/intrinsics: (4, 4) numpy. Returns host maps rgb
    (H, W, 3), depth (H, W), normal (H, W, 3) and acc (H, W); the pixel
    grid is x = column, y = row. With cfg.with_background the
    background model renders (`render_rays_bg`, the foreground
    unclamped) with the view directions of `near_pose` (4, 4), the
    nearest training view's camera, or of `pose` itself when None.
    `group`: the ranks that share each chunk (module docstring)."""
    check_model_ported(cfg)
    device = torch.device(device) if device is not None \
        else next(params.parameters()).device
    gen = gen if gen is not None \
        else torch.Generator(device=device).manual_seed(0)
    H, W = img_res
    ys, xs = np.mgrid[0:H, 0:W]
    uv = torch.as_tensor(
        np.stack([xs, ys], axis=-1).reshape(-1, 2).astype(np.float32),
        device=device)
    pose_b = torch.as_tensor(np.asarray(pose, np.float32), device=device)[None]
    intr_b = torch.as_tensor(np.asarray(intrinsics, np.float32),
                             device=device)[None]
    bounding = 0.0 if (cfg.white_bkgd or cfg.with_background) \
        else cfg.scene_bounding_sphere
    sdf_fn = sampler_sdf_fn(params, cfg, bounding)   # route, pack: per image
    if cfg.with_background:
        near_b = pose_b if near_pose is None else torch.as_tensor(
            np.asarray(near_pose, np.float32), device=device)[None]
        render = functools.partial(render_rays_bg, near_pose=near_b)
    else:
        render = render_rays
    keys = ("rgb_values", "depth_values", "normal_map", "acc")
    outs = {k: [] for k in keys}
    with torch.no_grad(), full_float32():
        def rows(u, g):
            o = render(params, cfg, u[None], pose_b, intr_b, gen,
                       training=False, fast=fast, sdf_fn=sdf_fn, ray_group=g)
            return {k: getattr(o, k).detach() for k in keys}

        for i in range(0, uv.shape[0], chunk):
            o = _rows_of(rows, uv[i:i + chunk], group)
            for k in keys:
                outs[k].append(o[k])
            del o
    cat = {k: torch.cat(v).cpu().numpy() for k, v in outs.items()}
    return {"rgb": cat["rgb_values"].reshape(H, W, 3),
            "depth": cat["depth_values"].reshape(H, W),
            "normal": cat["normal_map"].reshape(H, W, 3),
            "acc": cat["acc"].reshape(H, W)}
