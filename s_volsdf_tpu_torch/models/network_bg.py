"""VolSDF with the NeRF++ inverted-sphere background, for BlendedMVS
scenes (counterpart of s_volsdf_tpu/models/network_bg.py:30-272).

The foreground SDF is unclamped everywhere on this path (bounding sphere
0): the background covers what lies outside the sphere. The sampler's
no-grad sweep is `network.sampler_sdf_fn(params, cfg, 0.0)`, so on the
card it launches the fused kernel with its clamp off, as every other
sweep of the port does; the final samples go through the plain MLP with
their spatial gradient. The background is an SDF MLP over inverted-sphere
points (x', y', z', 1/r) and a 'nerf'-mode colour MLP, with |x| as its
density, composited by the foreground's residual transmittance. At eval
the view direction is the nearest training view's (`near_pose`).

The background MLPs are trained (autograd through
`layers.apply_linear`, outside any kernel) and, as in the JAX package,
their products are float32 whatever the precision knobs say: JAX's
`bg_mlp_raw` and `bg_rgb_mlp` call `apply_linear` without a compute
dtype. The foreground's MLPs follow the knobs as on the DTU path.

Stacked parameters of S scenes (the lockstep multi-scene step) render
at B = S as `models.network.render_rays` does: every MLP, the background
ones too, takes its flat points as S runs (`layers.by_scene`), beta is
each scene's, and the eikonal points are concatenated within each scene.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from s_volsdf_tpu_torch.config import ModelConfig, check_model_ported
from s_volsdf_tpu_torch.models import layers
from s_volsdf_tpu_torch.models.density import (abs_density, get_beta,
                                               laplace_density)
from s_volsdf_tpu_torch.models.embedder import embed_dim, positional_encoding
from s_volsdf_tpu_torch.models.network import (VolSDFParams, check_scenes,
                                               init_volsdf_params, per_ray,
                                               rgb_mlp, sampler_sdf_fn,
                                               sdf_feat_grad, sdf_gradient)
from s_volsdf_tpu_torch.models.sampler import error_bound_sample
from s_volsdf_tpu_torch.utils.cameras import (depth_scale_factor,
                                              get_camera_params)


class VolSDFBGParams(VolSDFParams):
    """The JAX {"sdf", "rgb", "density", "bg_sdf", "bg_rgb"} pytree."""

    def __init__(self, sdf: nn.ModuleList, rgb: nn.ModuleList,
                 density: nn.Module, bg_sdf: nn.ModuleList,
                 bg_rgb: nn.ModuleList):
        super().__init__(sdf, rgb, density)
        self.bg_sdf = bg_sdf
        self.bg_rgb = bg_rgb


class BGRenderOutput(NamedTuple):
    rgb_values: torch.Tensor        # (R, 3)
    depth_values: torch.Tensor      # (R, 1) the foreground's depth
    depth_values_all: torch.Tensor  # (R, 1) foreground and background
    depth_vals: torch.Tensor        # (R, S) per-sample z-depth
    weights: torch.Tensor           # (R, S) the foreground's
    xyz: torch.Tensor               # (R, S, 3)
    grad_theta: Optional[torch.Tensor]
    normal_map: Optional[torch.Tensor]
    acc: torch.Tensor               # (R,)


def init_volsdf_bg_params(gen: torch.Generator, cfg: ModelConfig,
                          device=None) -> VolSDFBGParams:
    """The foreground's parameters (`init_volsdf_params`), then the
    background SDF MLP and colour MLP, all from `gen`."""
    fg = init_volsdf_params(gen, cfg, device)
    bg = cfg.bg
    imp = bg.implicit
    bg_sdf = layers.init_sdf_mlp(
        gen, imp.d_in, imp.d_out, imp.dims, bg.feature_vector_size,
        imp.skip_in, imp.multires, imp.geometric_init, imp.bias,
        imp.weight_norm, device)
    ren = bg.rendering
    d_in0 = ren.d_in + bg.feature_vector_size + (
        embed_dim(ren.multires_view, 3) - 3)
    widths = [d_in0] + list(ren.dims) + [ren.d_out]
    bg_rgb = layers.init_mlp(gen, widths, ren.weight_norm, device)
    return VolSDFBGParams(fg.sdf, fg.rgb, fg.density, bg_sdf, bg_rgb)


def bg_mlp_raw(params: nn.ModuleList, cfg: ModelConfig,
               x: torch.Tensor) -> torch.Tensor:
    """The background SDF MLP on (N, 4) inverted-sphere points: (N, 1 +
    bg feature size), float32 products."""
    imp = cfg.bg.implicit
    S = layers.n_scenes(params)
    inp = positional_encoding(layers.by_scene(x, S), imp.multires)
    h = inp
    n_layers = len(params)
    inv_sqrt2 = 0.7071067811865475
    for l, p in enumerate(params):
        if l in imp.skip_in:
            h = torch.cat([h, inp], dim=-1) * inv_sqrt2
        h = layers.apply_linear(p, h)
        if l < n_layers - 1:
            h = layers.softplus_b(h, beta=100.0)
    return layers.flat(h, S)


def bg_rgb_mlp(params: nn.ModuleList, cfg: ModelConfig, view_dirs,
               feats) -> torch.Tensor:
    """The background colour MLP in 'nerf' mode: [PE(view), features]."""
    view_pe = positional_encoding(view_dirs, cfg.bg.rendering.multires_view)
    S = layers.n_scenes(params)
    h = layers.by_scene(torch.cat([view_pe, feats], dim=-1), S)
    n_layers = len(params)
    for l, p in enumerate(params):
        h = layers.apply_linear(p, h)
        if l < n_layers - 1:
            h = torch.relu(h)
    return layers.flat(torch.sigmoid(h), S)


def depth2pts_outside(ray_o, ray_d, depth, r: float):
    """Inverted-sphere points of inverse depths `depth` (...,) along rays
    from inside the sphere of radius r, by a Rodrigues rotation of the
    ray's sphere exit. Returns ((..., 4) points, the real depth along
    the ray). A ray through the origin has no rotation axis: its points
    are NaN (0/0), as in the JAX package."""
    o_dot_d = torch.sum(ray_d * ray_o, dim=-1)
    under_sqrt = o_dot_d ** 2 - (torch.sum(ray_o ** 2, dim=-1) - r ** 2)
    d_sphere = torch.sqrt(torch.clamp(under_sqrt, min=0.0)) - o_dot_d
    p_sphere = ray_o + d_sphere[..., None] * ray_d
    p_mid = ray_o - o_dot_d[..., None] * ray_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)

    rot_axis = torch.linalg.cross(ray_o, p_sphere, dim=-1)
    rot_axis = rot_axis / torch.linalg.norm(rot_axis, dim=-1, keepdim=True)
    phi = torch.asin(torch.clamp(p_mid_norm / r, -1.0, 1.0))
    theta = torch.asin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))
    rot_angle = (phi - theta)[..., None]

    p_new = (p_sphere * torch.cos(rot_angle)
             + torch.linalg.cross(rot_axis, p_sphere, dim=-1)
             * torch.sin(rot_angle)
             + rot_axis * torch.sum(rot_axis * p_sphere, dim=-1, keepdim=True)
             * (1.0 - torch.cos(rot_angle)))
    p_new = p_new / torch.linalg.norm(p_new, dim=-1, keepdim=True)
    pts = torch.cat([p_new, depth[..., None]], dim=-1)

    d1 = -o_dot_d / torch.sum(ray_d * ray_d, dim=-1)
    ray_d_cos = 1.0 / torch.linalg.norm(ray_d, dim=-1)
    depth_real = 1.0 / (depth + 1e-6) * torch.cos(theta) * ray_d_cos + d1
    return pts, depth_real


def _fg_volume_rendering(z_vals, z_max, density):
    """Foreground weights (R, S) with the last interval ending at the
    sphere's exit z_max (R,), and the transmittance left past it (R,)."""
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, z_max[:, None] - z_vals[:, -1:]], dim=-1)
    free_energy = dists * density
    shifted = torch.cat(
        [torch.zeros_like(free_energy[:, :1]), free_energy], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    weights = alpha * transmittance[:, :-1]
    return weights, transmittance[:, -1]


def _bg_volume_rendering(z_vals_bg, bg_density):
    """Background weights over inverse depths running from 1/r down to 0,
    the last interval 1e10."""
    dists = z_vals_bg[:, :-1] - z_vals_bg[:, 1:]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    free_energy = dists * bg_density
    shifted = torch.cat(
        [torch.zeros_like(free_energy[:, :1]), free_energy[:, :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha * transmittance


def render_rays_bg(params: VolSDFBGParams, cfg: ModelConfig, uv, pose,
                   intrinsics, gen: Optional[torch.Generator], *,
                   training: bool, fast: int, near_pose=None, jitter=None,
                   sdf_fn=None, ray_group=None) -> BGRenderOutput:
    """VolSDF with the background model for uv (B, N, 2), pose and
    intrinsics (B, 4, 4). jitter: the sampler's feed (with "t_rand_bg")
    plus "eik_pts" (R, 3) U[0,1). near_pose (B, 4, 4): at eval, the view
    directions of the foreground and background colour MLPs are that
    camera's rays through the same pixels. sdf_fn: the sampler's sweep
    (`sampler_sdf_fn(params, cfg, 0.0)`), made here when None.
    ray_group: as `network.render_rays`'s."""
    check_model_ported(cfg)
    ray_dirs, cam_loc = get_camera_params(uv, pose, intrinsics)
    depth_scale = depth_scale_factor(uv, intrinsics)

    B, N, _ = ray_dirs.shape
    R = B * N
    S_scenes = check_scenes(params, B, training=training, fast=fast,
                            jitter=jitter)
    ray_dirs = ray_dirs.reshape(R, 3)
    cam_loc = cam_loc[:, None, :].expand(B, N, 3).reshape(R, 3)
    depth_scale = depth_scale.reshape(R, 1)

    n_iters = fast if fast >= 0 else cfg.sampler.max_total_iters
    beta = get_beta(params.density, cfg.density.beta_min)
    beta0 = per_ray(beta.detach(), R)
    with torch.no_grad():
        s_out = error_bound_sample(
            gen, cfg.sampler, ray_dirs, cam_loc,
            sdf_fn or sampler_sdf_fn(params, cfg, 0.0), beta0,
            n_iters=n_iters, training=training,
            scene_bounding_sphere=cfg.scene_bounding_sphere, jitter=jitter,
            ray_group=ray_group)

    z_vals = s_out.z_vals
    z_max = z_vals[:, -1]
    z_vals = z_vals[:, :-1]
    S = z_vals.shape[1]

    points = cam_loc[:, None, :] + z_vals[..., None] * ray_dirs[:, None, :]
    points_flat = points.reshape(-1, 3)
    dirs_flat = ray_dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)

    sdf, feats, grads = sdf_feat_grad(params.sdf, cfg, points_flat, 0.0,
                                      create_graph=training)

    near = not training and near_pose is not None
    if near:
        dirs_near, _ = get_camera_params(uv, near_pose, intrinsics)
        dirs_near = dirs_near.reshape(R, 3)
        dirs_flat = dirs_near[:, None, :].expand(R, S, 3).reshape(-1, 3)

    rgb = rgb_mlp(params.rgb, cfg, points_flat, grads, dirs_flat,
                  feats).reshape(R, S, 3)

    if S_scenes:   # each scene's samples against its beta
        density = laplace_density(sdf[..., 0].reshape(S_scenes, -1),
                                  beta[:, None]).reshape(R, S)
    else:
        density = laplace_density(sdf[..., 0], beta).reshape(R, S)
    weights, bg_transmittance = _fg_volume_rendering(z_vals, z_max, density)
    fg_rgb_values = torch.sum(weights[..., None] * rgb, dim=1)

    # The background, over inverse depths from 1/r down to 0.
    z_vals_bg = torch.flip(s_out.z_vals_bg, dims=(-1,))
    NB = z_vals_bg.shape[1]
    bg_dirs = ray_dirs[:, None, :].expand(R, NB, 3)
    bg_locs = cam_loc[:, None, :].expand(R, NB, 3)
    bg_points, bg_depth_vals = depth2pts_outside(
        bg_locs, bg_dirs, z_vals_bg, cfg.scene_bounding_sphere)

    bg_out = bg_mlp_raw(params.bg_sdf, cfg, bg_points.reshape(-1, 4))
    bg_sdf = bg_out[:, :1]
    bg_feats = bg_out[:, 1:]
    bg_dirs_flat = bg_dirs.reshape(-1, 3)
    if near:
        bg_dirs_flat = dirs_near[:, None, :].expand(R, NB, 3).reshape(-1, 3)
    bg_rgb = bg_rgb_mlp(params.bg_rgb, cfg, bg_dirs_flat,
                        bg_feats).reshape(R, NB, 3)

    bg_density = abs_density(bg_sdf[:, 0]).reshape(R, NB)
    bg_weights = _bg_volume_rendering(z_vals_bg, bg_density)
    bg_rgb_values = torch.sum(bg_weights[..., None] * bg_rgb, dim=1)

    weights_all = torch.cat(
        [weights, bg_transmittance[:, None] * bg_weights], dim=1)
    depth_vals_all = depth_scale * torch.cat([z_vals, bg_depth_vals], dim=1)
    depth_values_all = torch.sum(weights_all * depth_vals_all, dim=1,
                                 keepdim=True) / (
        torch.sum(weights_all, dim=1, keepdim=True) + 1e-8)

    depth_vals = z_vals * depth_scale
    depth_values = torch.sum(weights * depth_vals, dim=1, keepdim=True) / (
        torch.sum(weights, dim=1, keepdim=True) + 1e-8)

    rgb_values = fg_rgb_values + bg_transmittance[:, None] * bg_rgb_values

    grad_theta = None
    normal_map = None
    if training:
        r = cfg.scene_bounding_sphere
        if jitter is not None:
            eik_u = jitter["eik_pts"]
        else:
            eik_u = torch.rand((R, 3), generator=gen, dtype=ray_dirs.dtype,
                               device=ray_dirs.device)
        eik_uniform = -r + 2.0 * r * eik_u
        eik_near = cam_loc + s_out.z_samples_eik * ray_dirs
        if S_scenes:    # each scene's 2N points together
            eik_points = torch.cat([eik_uniform.reshape(B, N, 3),
                                    eik_near.reshape(B, N, 3)],
                                   dim=1).reshape(2 * R, 3)
        else:
            eik_points = torch.cat([eik_uniform, eik_near], dim=0)
        grad_theta = sdf_gradient(params.sdf, cfg, eik_points, 0.0)
    else:
        g = grads.detach()
        normals = (g / torch.linalg.norm(g, dim=-1, keepdim=True)
                   ).reshape(R, S, 3)
        normal_map = torch.sum(weights[..., None] * normals, dim=1)

    return BGRenderOutput(
        rgb_values=rgb_values,
        depth_values=depth_values,
        depth_values_all=depth_values_all,
        depth_vals=depth_vals,
        weights=weights,
        xyz=points.detach(),
        grad_theta=grad_theta,
        normal_map=normal_map,
        acc=torch.sum(weights_all, dim=-1),
    )
