"""VolSDF foreground network: SDF MLP + radiance MLP + volume rendering
(counterpart of s_volsdf_tpu/models/network.py:28-321).

Parameters live in `VolSDFParams`, an nn.Module whose leaves keep the
JAX pytree's names and layouts: sdf.<l>.{v,g,b}, rgb.<l>.{v,g,b},
density.beta (bridge.py converts between the two).

The sampler's SDF sweep goes through `ops.fused_sdf.fused_sdf_values`
(the CUDA kernel) under no_grad on detached parameters, packed once per
step, when the parameters are on the card and the config is in the
kernel's family; otherwise through the plain MLP (`sampler_sdf_fn`).
The gradient-carrying SDF evaluations (`sdf_feat_grad`,
`sdf_gradient`) run the plain MLP and take the spatial gradient with
`torch.autograd.grad(..., create_graph=True)`, so the eikonal term and
the normals fed to the radiance MLP train the SDF (double backprop).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from s_volsdf_tpu_torch.config import ModelConfig, check_model_ported
from s_volsdf_tpu_torch.models import layers
from s_volsdf_tpu_torch.models.density import (get_beta, init_laplace_density,
                                               laplace_density)
from s_volsdf_tpu_torch.models.embedder import embed_dim, positional_encoding
from s_volsdf_tpu_torch.models.sampler import error_bound_sample
from s_volsdf_tpu_torch.ops import fused_sdf
from s_volsdf_tpu_torch.ops.fused_sdf import (fused_sdf_values, pack_sdf,
                                              supported)
from s_volsdf_tpu_torch.utils.cameras import (depth_scale_factor,
                                              get_camera_params)


class VolSDFParams(nn.Module):
    """The JAX {"sdf": [...], "rgb": [...], "density": {...}} pytree."""

    def __init__(self, sdf: nn.ModuleList, rgb: nn.ModuleList,
                 density: nn.Module):
        super().__init__()
        self.sdf = sdf
        self.rgb = rgb
        self.density = density


def init_volsdf_params(gen: torch.Generator, cfg: ModelConfig,
                       device=None) -> VolSDFParams:
    """Geometric init from `gen` (a CPU generator, so a seed gives the
    same weights on every device)."""
    imp = cfg.implicit
    sdf = layers.init_sdf_mlp(
        gen, imp.d_in, imp.d_out, imp.dims, cfg.feature_vector_size,
        imp.skip_in, imp.multires, imp.geometric_init, imp.bias,
        imp.weight_norm, device)
    ren = cfg.rendering
    d_view = embed_dim(ren.multires_view, 3)
    # idr input: [points(3), view_pe, normals(3), features].
    d_in0 = ren.d_in + cfg.feature_vector_size + (d_view - 3)
    widths = [d_in0] + list(ren.dims) + [ren.d_out]
    rgb = layers.init_mlp(gen, widths, ren.weight_norm, device)
    density = init_laplace_density(cfg.density.beta_init, device)
    return VolSDFParams(sdf, rgb, density)


def compute_dtype(cfg: ModelConfig) -> Optional[torch.dtype]:
    """torch.bfloat16 for bf16 products, else None (float32)."""
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def activation_dtype(cfg: ModelConfig) -> Optional[torch.dtype]:
    """The dtype of hidden activations between MLP layers: bf16 only
    alongside bf16 products (bf16 activations feeding float32 products
    would round inputs for nothing), else None (float32)."""
    if cfg.activation_dtype == "bfloat16" and cfg.compute_dtype == "bfloat16":
        return torch.bfloat16
    return None


# --------------------------------------------------------------------------
# SDF network
# --------------------------------------------------------------------------

def sdf_mlp_raw(params: nn.ModuleList, cfg: ModelConfig,
                x: torch.Tensor) -> torch.Tensor:
    """Raw MLP output (N, 1 + feature_size), float32. The skip junction
    is [h, pe] * 1/sqrt(2), in that order, in the activations' dtype."""
    imp = cfg.implicit
    dt, act_dt = compute_dtype(cfg), activation_dtype(cfg)
    inp = positional_encoding(x, imp.multires)
    h = inp
    n_layers = len(params)
    inv_sqrt2 = 0.7071067811865475
    for l, p in enumerate(params):
        if l in imp.skip_in:
            h = torch.cat([h, inp.to(h.dtype)], dim=-1) * torch.tensor(
                inv_sqrt2, dtype=h.dtype)
        h = layers.apply_linear(p, h, dt)
        if l < n_layers - 1:
            if act_dt is not None:
                h = h.to(act_dt)
            h = layers.softplus_b(h, beta=100.0)
    return h


def _clamp_sdf(sdf, x, cfg: ModelConfig, bounding_sphere: float):
    """min(sdf, sphere_scale * (r - ||x||)) so rays terminate."""
    if bounding_sphere > 0.0:
        sphere_sdf = cfg.implicit.sphere_scale * (
            bounding_sphere - torch.linalg.norm(x, dim=-1, keepdim=True))
        sdf = torch.minimum(sdf, sphere_sdf)
    return sdf


def sdf_values(params, cfg: ModelConfig, x, bounding_sphere: float):
    """Clamped SDF values (N,)."""
    out = sdf_mlp_raw(params, cfg, x)
    return _clamp_sdf(out[..., :1], x, cfg, bounding_sphere)[..., 0]


def sdf_feat_grad(params, cfg: ModelConfig, x, bounding_sphere: float,
                  create_graph: bool = True):
    """(sdf (N, 1), features (N, F), d sdf/dx (N, 3)). The gradient is
    of the CLAMPED sdf and, with create_graph, stays differentiable in
    the parameters."""
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        out = sdf_mlp_raw(params, cfg, x)
        sdf = _clamp_sdf(out[..., :1], x, cfg, bounding_sphere)
        (grads,) = torch.autograd.grad(sdf.sum(), x, create_graph=create_graph)
    return sdf, out[..., 1:], grads


def sdf_gradient(params, cfg: ModelConfig, x,
                 bounding_sphere: float) -> torch.Tensor:
    """d sdf/dx (N, 3) for the eikonal points, of the UNCLAMPED sdf,
    differentiable in the parameters."""
    del bounding_sphere
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        sdf = sdf_mlp_raw(params, cfg, x)[:, 0]
        (grads,) = torch.autograd.grad(sdf.sum(), x, create_graph=True)
    return grads


# --------------------------------------------------------------------------
# Radiance network and compositing
# --------------------------------------------------------------------------

def rgb_mlp(params: nn.ModuleList, cfg: ModelConfig, points, normals,
            view_dirs, feats):
    ren = cfg.rendering
    view_pe = positional_encoding(view_dirs, ren.multires_view)
    if ren.mode == "idr":
        h = torch.cat([points, view_pe, normals, feats], dim=-1)
    elif ren.mode == "nerf":
        h = torch.cat([view_pe, feats], dim=-1)
    else:
        raise ValueError(ren.mode)
    dt, act_dt = compute_dtype(cfg), activation_dtype(cfg)
    n_layers = len(params)
    for l, p in enumerate(params):
        h = layers.apply_linear(p, h, dt)
        if l < n_layers - 1:
            if act_dt is not None:
                h = h.to(act_dt)
            h = torch.relu(h)
    return torch.sigmoid(h)


def volume_rendering(z_vals, density):
    """Alpha-compositing weights (R, S) from density (R, S)."""
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    free_energy = dists * density
    shifted = torch.cat(
        [torch.zeros_like(free_energy[:, :1]), free_energy[:, :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha * transmittance


class RenderOutput(NamedTuple):
    rgb_values: torch.Tensor        # (R, 3)
    depth_values: torch.Tensor      # (R, 1) z-depth
    depth_vals: torch.Tensor        # (R, S) per-sample z-depth
    weights: torch.Tensor           # (R, S)
    xyz: torch.Tensor               # (R, S, 3) world sample points
    grad_theta: Optional[torch.Tensor]   # eikonal grads (training)
    normal_map: Optional[torch.Tensor]   # (R, 3) (eval)
    acc: torch.Tensor               # (R,)


def uses_kernel(params: VolSDFParams, cfg: ModelConfig) -> bool:
    """Whether the sampler's sweeps launch the fused kernel: parameters
    on a CUDA device and a config in the kernel's family."""
    return params.sdf[0].b.device.type == "cuda" and supported(cfg)


def sampler_sdf_fn(params: VolSDFParams, cfg: ModelConfig,
                   bounding_sphere: float):
    """The sampler's no-grad SDF sweep, for every sweep the returned
    function serves (a training step's, or a whole render's). The route
    is chosen here, once, from the parameters' device and the config:
    on a CUDA device with a config in the fused kernel's family
    (`fused_sdf.supported`), the weights are packed once (`pack_sdf`, in
    the mode `cfg`'s precision names) and every sweep launches the
    kernel; in any other case (the CPU, or a config outside the family,
    which the JAX package also runs through its plain `sdf_values`)
    every sweep is `sdf_values_plain`, counted in
    `fused_sdf.plain_sweeps`, and nothing is packed."""
    if not uses_kernel(params, cfg):
        def plain_fn(pts):
            fused_sdf.plain_sweeps += 1
            return fused_sdf.sdf_values_plain(params.sdf, cfg, pts,
                                              bounding_sphere)
        return plain_fn

    pack = pack_sdf(params.sdf, cfg)

    def sdf_fn(pts):
        with torch.no_grad():
            return fused_sdf_values(params.sdf, cfg, pts, bounding_sphere,
                                    pack=pack)
    return sdf_fn


def render_rays(params: VolSDFParams, cfg: ModelConfig, uv, pose, intrinsics,
                gen: Optional[torch.Generator], *, training: bool, fast: int,
                jitter=None, sdf_fn=None) -> RenderOutput:
    """VolSDF forward for uv (B, N, 2), pose/intrinsics (B, 4, 4); rays
    are flattened to R = B*N. fast: sampler iterations, -1 for
    cfg.sampler.max_total_iters. jitter: the sampler feed plus "eik_pts"
    (R, 3) U[0,1) for the uniform eikonal points. sdf_fn: the sampler's
    sweep (`sampler_sdf_fn` of these parameters, made once for many
    calls, as a render does); made here when None."""
    check_model_ported(cfg)
    bounding_sphere = 0.0 if cfg.white_bkgd else cfg.scene_bounding_sphere
    ray_dirs, cam_loc = get_camera_params(uv, pose, intrinsics)
    depth_scale = depth_scale_factor(uv, intrinsics)

    B, N, _ = ray_dirs.shape
    R = B * N
    ray_dirs = ray_dirs.reshape(R, 3)
    cam_loc = cam_loc[:, None, :].expand(B, N, 3).reshape(R, 3)
    depth_scale = depth_scale.reshape(R, 1)

    n_iters = fast if fast >= 0 else cfg.sampler.max_total_iters
    beta0 = get_beta(params.density, cfg.density.beta_min).detach()
    with torch.no_grad():
        s_out = error_bound_sample(
            gen, cfg.sampler, ray_dirs, cam_loc,
            sdf_fn or sampler_sdf_fn(params, cfg, bounding_sphere), beta0,
            n_iters=n_iters, training=training,
            scene_bounding_sphere=cfg.scene_bounding_sphere, jitter=jitter)
    z_vals = s_out.z_vals
    S = z_vals.shape[1]

    points = cam_loc[:, None, :] + z_vals[..., None] * ray_dirs[:, None, :]
    points_flat = points.reshape(-1, 3)
    dirs_flat = ray_dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)

    sdf, feats, grads = sdf_feat_grad(params.sdf, cfg, points_flat,
                                      bounding_sphere, create_graph=training)
    rgb = rgb_mlp(params.rgb, cfg, points_flat, grads, dirs_flat,
                  feats).reshape(R, S, 3)

    beta = get_beta(params.density, cfg.density.beta_min)
    density = laplace_density(sdf[..., 0], beta).reshape(R, S)
    weights = volume_rendering(z_vals, density)

    rgb_values = torch.sum(weights[..., None] * rgb, dim=1)
    depth_values = torch.sum(weights * z_vals, dim=1, keepdim=True) / (
        torch.sum(weights, dim=1, keepdim=True) + 1e-8)
    depth_values = depth_scale * depth_values

    acc = torch.sum(weights, dim=-1)
    if cfg.white_bkgd:
        bg = torch.tensor(cfg.bg_color, dtype=rgb_values.dtype,
                          device=rgb_values.device)
        rgb_values = rgb_values + (1.0 - acc[..., None]) * bg

    grad_theta = None
    normal_map = None
    if training:
        # Eikonal points: uniform in the bounding cube + near-surface.
        r = cfg.scene_bounding_sphere
        if jitter is not None:
            eik_u = jitter["eik_pts"]
        else:
            eik_u = torch.rand((R, 3), generator=gen, dtype=ray_dirs.dtype,
                               device=ray_dirs.device)
        eik_uniform = -r + 2.0 * r * eik_u
        eik_near = cam_loc + s_out.z_samples_eik * ray_dirs
        eik_points = torch.cat([eik_uniform, eik_near], dim=0)
        grad_theta = sdf_gradient(params.sdf, cfg, eik_points, bounding_sphere)
    else:
        g = grads.detach()
        normals = (g / torch.linalg.norm(g, dim=-1, keepdim=True)).reshape(R, S, 3)
        normal_map = torch.sum(weights[..., None] * normals, dim=1)

    return RenderOutput(
        rgb_values=rgb_values,
        depth_values=depth_values,
        depth_vals=z_vals * depth_scale,
        weights=weights,
        xyz=points,
        grad_theta=grad_theta,
        normal_map=normal_map,
        acc=acc,
    )
