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

Stacked parameters (`stack_params`: every leaf with a leading scene axis
S) are S scenes' independent models, the counterpart of the JAX
package's `vmap` over stacked states (engine/multiscene.py). The
training render takes them at B = S (scene s's N rays are batch entry
s): each MLP moves its flat points to (S, R/S*K, d) for batched
products (`layers.by_scene`), the density takes each scene's beta and
the sampler a per-ray beta0 (each scene's repeated for its N rays), the
eikonal points are concatenated within each scene, the
sampler's sweep is one kernel launch for the S scenes, and the random
draws come from the `jitter` feed (each scene's from its own generator,
engine/train_step.draw_step_inputs). Only the training sampler at
fast=1 takes S > 1: at fast > 1 the global early exit would tie the
scenes together. Renders for feedback and eval run per scene
(`unstack_params`).
"""

from __future__ import annotations

import copy
from typing import List, NamedTuple, Optional

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
                                              pack_sdf_scenes, supported)
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


def map_leaves(params: nn.Module, fn) -> nn.Module:
    """A copy of a parameter tree with each leaf p (named as in
    named_parameters) replaced by nn.Parameter(fn(name, p))."""
    out = copy.deepcopy(params)
    mods = dict(out.named_modules())
    for name, p in list(out.named_parameters()):
        mod, _, leaf = name.rpartition(".")
        setattr(mods[mod], leaf, nn.Parameter(fn(name, p)))
    return out


def stack_params(params_list: List[nn.Module]) -> nn.Module:
    """S scenes' parameter trees (VolSDFParams or VolSDFBGParams of one
    config) as one tree of the same type whose every leaf carries a
    leading scene axis: v (S, in, out), g and b (S, out), beta (S,)."""
    leaves = [dict(p.named_parameters()) for p in params_list]
    with torch.no_grad():
        return map_leaves(params_list[0], lambda name, _: torch.stack(
            [lv[name].detach() for lv in leaves]))


def unstack_params(stacked: nn.Module, s: int) -> nn.Module:
    """Scene s of stacked parameters, as a tree of its own (copies)."""
    with torch.no_grad():
        return map_leaves(stacked, lambda _, p: p.detach()[s].clone())


def n_scenes(params: nn.Module) -> int:
    """S for stacked parameters (`stack_params`), else 0."""
    return layers.n_scenes(params.sdf)


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
    is [h, pe] * 1/sqrt(2), in that order, in the activations' dtype.
    Stacked parameters of S scenes take x (N, 3) as S runs of N/S."""
    imp = cfg.implicit
    dt, act_dt = compute_dtype(cfg), activation_dtype(cfg)
    S = layers.n_scenes(params)
    inp = positional_encoding(layers.by_scene(x, S), imp.multires)
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
    return layers.flat(h, S)


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
    S = layers.n_scenes(params)
    h = layers.by_scene(h, S)
    n_layers = len(params)
    for l, p in enumerate(params):
        h = layers.apply_linear(p, h, dt)
        if l < n_layers - 1:
            if act_dt is not None:
                h = h.to(act_dt)
            h = torch.relu(h)
    return layers.flat(torch.sigmoid(h), S)


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
    `fused_sdf.plain_sweeps`, and nothing is packed. Stacked parameters
    of S scenes take flat points (M, 3) as S runs of M/S: one pack
    (`pack_sdf_scenes`) and one launch a sweep for the S scenes."""
    S = n_scenes(params)

    def scenes(pts):
        return pts.reshape(S, -1, 3) if S else pts

    if not uses_kernel(params, cfg):
        def plain_fn(pts):
            fused_sdf.plain_sweeps += 1
            return fused_sdf.sdf_values_plain(
                params.sdf, cfg, scenes(pts), bounding_sphere).reshape(-1)
        return plain_fn

    pack = (pack_sdf_scenes if S else pack_sdf)(params.sdf, cfg)

    def sdf_fn(pts):
        with torch.no_grad():
            return fused_sdf_values(params.sdf, cfg, scenes(pts),
                                    bounding_sphere, pack=pack).reshape(-1)
    return sdf_fn


def per_ray(beta: torch.Tensor, n_rays: int) -> torch.Tensor:
    """A scalar beta as it is; S scenes' betas (S,) as (R,), each
    scene's repeated for its R/S rays."""
    return beta if beta.dim() == 0 else beta.repeat_interleave(
        n_rays // beta.shape[0])


def check_scenes(params: VolSDFParams, B: int, *, training: bool,
                 fast: int, jitter) -> int:
    """S for stacked parameters, after checking what a stacked render
    takes: B = S batch entries (one per scene), the training sampler at
    fast=1 and the `jitter` feed; 0 for parameters without a scene
    axis."""
    S = n_scenes(params)
    if S and (B != S or not training or fast != 1 or jitter is None):
        raise ValueError(
            f"a render of {S} scenes' stacked parameters takes one batch "
            f"entry a scene (got {B}), training=True and fast=1 (got "
            f"{training}, {fast}; at fast > 1 the sampler's global early "
            f"exit would tie the scenes together) and the scenes' jitter "
            f"feed (engine.train_step.draw_step_inputs); render a scene "
            f"at a time with unstack_params")
    return S


def render_rays(params: VolSDFParams, cfg: ModelConfig, uv, pose, intrinsics,
                gen: Optional[torch.Generator], *, training: bool, fast: int,
                jitter=None, sdf_fn=None, ray_group=None) -> RenderOutput:
    """VolSDF forward for uv (B, N, 2), pose/intrinsics (B, 4, 4); rays
    are flattened to R = B*N. fast: sampler iterations, -1 for
    cfg.sampler.max_total_iters. jitter: the sampler feed plus "eik_pts"
    (R, 3) U[0,1) for the uniform eikonal points. sdf_fn: the sampler's
    sweep (`sampler_sdf_fn` of these parameters, made once for many
    calls, as a render does); made here when None. ray_group: the ranks
    holding the other rows of a sharded render's rays (the sampler's
    early exit tests them all)."""
    check_model_ported(cfg)
    bounding_sphere = 0.0 if cfg.white_bkgd else cfg.scene_bounding_sphere
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
            sdf_fn or sampler_sdf_fn(params, cfg, bounding_sphere), beta0,
            n_iters=n_iters, training=training,
            scene_bounding_sphere=cfg.scene_bounding_sphere, jitter=jitter,
            ray_group=ray_group)
    z_vals = s_out.z_vals
    S = z_vals.shape[1]

    points = cam_loc[:, None, :] + z_vals[..., None] * ray_dirs[:, None, :]
    points_flat = points.reshape(-1, 3)
    dirs_flat = ray_dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)

    sdf, feats, grads = sdf_feat_grad(params.sdf, cfg, points_flat,
                                      bounding_sphere, create_graph=training)
    rgb = rgb_mlp(params.rgb, cfg, points_flat, grads, dirs_flat,
                  feats).reshape(R, S, 3)

    if S_scenes:   # each scene's samples against its beta
        density = laplace_density(sdf[..., 0].reshape(S_scenes, -1),
                                  beta[:, None]).reshape(R, S)
    else:
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
        if S_scenes:    # each scene's 2N points together
            eik_points = torch.cat([eik_uniform.reshape(B, N, 3),
                                    eik_near.reshape(B, N, 3)],
                                   dim=1).reshape(2 * R, 3)
        else:
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
