"""Error-bound ray sampler (VolSDF Algorithm 1) with the JAX package's
static iteration schedule (counterpart of
s_volsdf_tpu/models/sampler.py:53-402).

The schedule is the JAX one: `n_iters` iterations, the last always the
final-sample one; once every ray's bisected beta reaches beta0 (the
global early exit), the remaining refine iterations append duplicates of
the far sample (`dup`) instead of evaluating the SDF, so shapes stay the
same as the JAX package's. In JAX that test is a `lax.cond` on a device
scalar; here it is a Python `if` on `.item()`, one host sync per sampler
iteration (training at fast=1 has none).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from s_volsdf_tpu_torch.config import RaySamplerConfig
from s_volsdf_tpu_torch.models.density import laplace_density
from s_volsdf_tpu_torch.ops.inverse_cdf import pdf_to_cdf, sample_pdf_from_cdf
from s_volsdf_tpu_torch.utils.cameras import get_sphere_intersections


def merge_sorted_pairs(za, sa, zb, sb):
    """Merge two per-ray sorted (z, payload) pairs into one sorted pair,
    in the JAX rank-merge's exact order: a NaN z ranks as +inf (rays
    that miss the bounding sphere), and on ties a-elements come before
    b-elements, each input keeping its own order. A stable sort of the
    concatenation [a, b] on NaN->+inf keys gives exactly that order."""
    z = torch.cat([za, zb], dim=-1)
    s = torch.cat([sa, sb], dim=-1)
    keys = torch.where(torch.isnan(z), torch.full_like(z, math.inf), z)
    order = torch.sort(keys, dim=-1, stable=True).indices
    return torch.gather(z, -1, order), torch.gather(s, -1, order)


class SamplerOutput(NamedTuple):
    z_vals: torch.Tensor                # (R, N_final) sorted
    z_samples_eik: torch.Tensor         # (R, 1) random near-surface z
    z_vals_bg: Optional[torch.Tensor]   # (R, N_bg) inverse depths, or None
    converged_iter: int                 # iteration after which the early exit engaged


def _linspace(n: int, like: torch.Tensor) -> torch.Tensor:
    return torch.linspace(0.0, 1.0, n, dtype=like.dtype, device=like.device)


def uniform_z_vals(gen, cfg: RaySamplerConfig, ray_dirs, cam_loc, far,
                   n_samples: int, training: bool,
                   take_sphere_intersection: bool,
                   scene_bounding_sphere: float, t_rand=None):
    """Stratified z in [near, far] (R, n_samples); in training each bin
    is jittered by t_rand (R, n_samples) U[0,1), drawn from `gen` when
    not given."""
    R = ray_dirs.shape[0]
    near = torch.full((R, 1), cfg.near, dtype=ray_dirs.dtype,
                      device=ray_dirs.device)
    if take_sphere_intersection:
        sph = get_sphere_intersections(cam_loc, ray_dirs,
                                       r=scene_bounding_sphere)
        # far >= near keeps the linspace ascending (merge_sorted_pairs
        # needs sorted inputs).
        far_v = torch.maximum(sph[:, 1:], near)
    else:
        far_v = torch.full((R, 1), far, dtype=ray_dirs.dtype,
                           device=ray_dirs.device)

    t_vals = _linspace(n_samples, ray_dirs)
    z_vals = near * (1.0 - t_vals) + far_v * t_vals
    if training:
        mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
        lower = torch.cat([z_vals[..., :1], mids], dim=-1)
        if t_rand is None:
            t_rand = torch.rand(z_vals.shape, generator=gen,
                                dtype=z_vals.dtype, device=z_vals.device)
        z_vals = lower + (upper - lower) * t_rand.to(z_vals.dtype)
    return z_vals


def _d_star(z_vals, sdf):
    """Per-interval min-distance bound d* (Theorem 1)."""
    d = sdf
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    a, b, c = dists, torch.abs(d[:, :-1]), torch.abs(d[:, 1:])
    first = a ** 2 + b ** 2 <= c ** 2
    second = a ** 2 + c ** 2 <= b ** 2
    s = (a + b + c) / 2.0
    area = s * (s - a) * (s - b) * (s - c)
    height = 2.0 * torch.sqrt(torch.clamp(area, min=0.0)) \
        / torch.clamp(a, min=1e-12)
    inner = (~first) & (~second) & (b + c - a > 0)
    zero = torch.zeros_like(b)
    d_star = torch.where(first, b, zero)
    d_star = torch.where(second, c, d_star)
    d_star = torch.where(inner, height, d_star)
    same_sign = torch.sign(d[:, 1:]) * torch.sign(d[:, :-1]) == 1
    return torch.where(same_sign, d_star, zero)


def _error_bound(beta, sdf, z_vals, dists, d_star):
    """Max per-ray opacity error bound. beta: (R, 1) or scalar."""
    density = laplace_density(sdf, beta)
    shifted = torch.cat(
        [torch.zeros_like(dists[:, :1]), dists * density[:, :-1]], dim=-1)
    integral_estimation = torch.cumsum(shifted, dim=-1)
    error_per_section = torch.exp(-d_star / beta) * (dists ** 2) / (4 * beta ** 2)
    error_integral = torch.cumsum(error_per_section, dim=-1)
    bound_opacity = (torch.clamp(torch.exp(error_integral), max=1e6) - 1.0) \
        * torch.exp(-integral_estimation[:, :-1])
    return torch.max(bound_opacity, dim=-1).values


def _weights(z_vals, sdf, beta):
    """Alpha-compositing weights under per-ray beta (R, 1). Returns
    (weights, dists, transmittance)."""
    density = laplace_density(sdf, beta)
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists_inf = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    free_energy = dists_inf * density
    shifted = torch.cat(
        [torch.zeros_like(free_energy[:, :1]), free_energy[:, :-1]], dim=-1)
    alpha = 1.0 - torch.exp(-free_energy)
    transmittance = torch.exp(-torch.cumsum(shifted, dim=-1))
    return alpha * transmittance, dists, transmittance


def error_bound_sample(gen, cfg: RaySamplerConfig, ray_dirs, cam_loc,
                       sdf_fn, beta0, *, n_iters: int, training: bool,
                       scene_bounding_sphere: float,
                       jitter=None, ray_group=None) -> SamplerOutput:
    """ErrorBoundSampler.get_z_vals with the static iteration schedule.

    sdf_fn: points (M, 3) -> sdf (M,), no gradient needed.
    beta0: scalar tensor, the current density beta (detached); or, for
      S scenes in lockstep (stacked parameters, models/network.py), an
      (R,) tensor of each ray's scene's beta, with n_iters 1 (the
      training fast=1 path, where no early exit ties the rays together)
      and "extra_idx" (S, N_extra), each scene's column picks.
    n_iters: 1 in training (fast=1), max_total_iters in eval.
    jitter: optional feed replacing every random draw — "t_rand"
      (R, N_eval) U[0,1), "u_final" (R, N_samples) U[0,1), "extra_idx"
      (N_extra,) int column picks, "eik_idx" (R, 1) int and, with
      inverse_sphere_bg, "t_rand_bg" (R, N_samples_inverse_sphere)
      U[0,1) — the JAX package's seam, plus the background draw that its
      seam leaves to the key; defined for the training fast=1 path.
    gen: torch.Generator for the draws that `jitter` does not replace.
    ray_group: the group of ranks that holds the other rows of these
      rays (a sharded render, parallel.mesh.Group): the global early
      exit then tests every rank's rays, as one process would.

    With cfg.inverse_sphere_bg (a background model), the uniform samples
    end at the bounding sphere's exit (pinned to >= near), the final far
    column is that exit (not pinned), and `z_vals_bg` holds
    N_samples_inverse_sphere inverse depths, stratified in [0, 1] and
    scaled by 1/r.
    """
    far = 2.0 * scene_bounding_sphere
    R = ray_dirs.shape[0]
    dev = ray_dirs.device
    if jitter is not None and not (n_iters == 1 and training):
        raise ValueError("jitter injection is defined for the training "
                         "fast=1 path")
    if beta0.dim() == 1 and n_iters != 1:
        raise ValueError("a per-ray beta0 (scenes in lockstep) is defined "
                         "for n_iters 1")
    # beta0 against (R, K) per-sample tensors.
    beta0_col = beta0[:, None] if beta0.dim() == 1 else beta0

    def eval_sdf(z):
        pts = cam_loc[:, None, :] + z[..., None] * ray_dirs[:, None, :]
        return sdf_fn(pts.reshape(-1, 3)).reshape(z.shape)

    z_vals = uniform_z_vals(
        gen, cfg, ray_dirs, cam_loc, far, cfg.N_samples_eval, training,
        cfg.inverse_sphere_bg, scene_bounding_sphere,
        t_rand=None if jitter is None else jitter["t_rand"])
    sdf = eval_sdf(z_vals)

    # Beta upper bound from Lemma 2.
    dists0 = z_vals[:, 1:] - z_vals[:, :-1]
    log_eps1 = math.log(cfg.eps + 1.0)
    beta = torch.sqrt((1.0 / (4.0 * log_eps1)) * torch.sum(dists0 ** 2, dim=-1))

    def bisect_beta(z_vals, sdf, beta, d_star, dists):
        """Bisection for the minimal beta with error <= eps."""
        curr_error = _error_bound(beta0_col, sdf, z_vals, dists, d_star)
        beta = torch.where(curr_error <= cfg.eps, beta0, beta)
        beta_lo = beta0.expand_as(beta)
        beta_hi = beta
        for _ in range(cfg.beta_iters):
            beta_mid = 0.5 * (beta_lo + beta_hi)
            err = _error_bound(beta_mid[:, None], sdf, z_vals, dists, d_star)
            ok = err <= cfg.eps
            beta_hi = torch.where(ok, beta_mid, beta_hi)
            beta_lo = torch.where(ok, beta_lo, beta_mid)
        return beta_hi

    def dup(z_vals, sdf):
        """Zero-length duplicates of the far sample: leave every
        downstream integral and pdf unchanged."""
        K = cfg.N_samples_eval
        return (torch.cat([z_vals, z_vals[:, -1:].expand(R, K)], dim=-1),
                torch.cat([sdf, sdf[:, -1:].expand(R, K)], dim=-1))

    def upsample_iter(z_vals, sdf, beta_in):
        """One non-final iteration: bisect, test the global early exit,
        then refine or duplicate."""
        d_star = _d_star(z_vals, sdf)
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        beta = bisect_beta(z_vals, sdf, beta_in, d_star, dists)
        _, _, transmittance = _weights(z_vals, sdf, beta[:, None])
        # One host sync: every ray's bisected beta is at beta0.
        top = torch.max(beta)
        if ray_group is not None:
            top = ray_group.max(top)
        converged = bool((top <= beta0).item())
        if converged:
            z2, s2 = dup(z_vals, sdf)
            return z2, s2, beta, True
        # Sample proportional to the error bound.
        error_per_section = (torch.exp(-d_star / beta[:, None])
                             * (dists ** 2) / (4 * beta[:, None] ** 2))
        error_integral = torch.cumsum(error_per_section, dim=-1)
        bound_opacity = \
            (torch.clamp(torch.exp(error_integral), max=1e6) - 1.0) \
            * transmittance[:, :-1]
        pdf = bound_opacity + cfg.add_tiny
        cdf = pdf_to_cdf(pdf)
        u = _linspace(cfg.N_samples_eval, z_vals).expand(R, cfg.N_samples_eval)
        new_samples = sample_pdf_from_cdf(z_vals, cdf, u.contiguous())
        new_sdf = eval_sdf(new_samples)
        z2, s2 = merge_sorted_pairs(z_vals, sdf, new_samples, new_sdf)
        return z2, s2, beta, False

    def final_pdf(z_vals, sdf, beta_in):
        d_star = _d_star(z_vals, sdf)
        dists = z_vals[:, 1:] - z_vals[:, :-1]
        beta = bisect_beta(z_vals, sdf, beta_in, d_star, dists)
        weights, _, _ = _weights(z_vals, sdf, beta[:, None])
        return weights[..., :-1] + 1e-5

    def final_pdf_converged(z_vals, sdf):
        """After the global early exit the bisection is pinned at beta0."""
        weights, _, _ = _weights(z_vals, sdf, beta0.expand(R)[:, None])
        return weights[..., :-1] + 1e-5

    converged = False
    conv_iter = n_iters
    for it in range(n_iters - 1):
        if converged:
            z_vals, sdf = dup(z_vals, sdf)
        else:
            z_vals, sdf, beta, converged = upsample_iter(z_vals, sdf, beta)
            if converged:
                conv_iter = it + 1
    pdf = (final_pdf_converged(z_vals, sdf) if converged
           else final_pdf(z_vals, sdf, beta))
    cdf = pdf_to_cdf(pdf)
    if jitter is not None:
        u = jitter["u_final"]
    elif training:
        u = torch.rand((R, cfg.N_samples), generator=gen,
                       dtype=z_vals.dtype, device=dev)
    else:
        u = _linspace(cfg.N_samples, z_vals).expand(R, cfg.N_samples)
    samples = sample_pdf_from_cdf(z_vals, cdf, u.contiguous())

    # Extra samples + near/far.
    near_col = torch.full((R, 1), cfg.near, dtype=z_vals.dtype, device=dev)
    if cfg.inverse_sphere_bg:
        far_col = get_sphere_intersections(
            cam_loc, ray_dirs, r=scene_bounding_sphere)[:, 1:]
    else:
        far_col = torch.full((R, 1), far, dtype=z_vals.dtype, device=dev)
    K = z_vals.shape[1]
    if cfg.N_samples_extra > 0:
        if jitter is not None:
            idx = jitter["extra_idx"]
            if idx.dim() == 2:   # each scene's columns for its R/S rays
                idx = idx.long().repeat_interleave(R // idx.shape[0], dim=0)
        elif training:
            idx = torch.randperm(K, generator=gen, device=dev)[: cfg.N_samples_extra]
        else:
            # numpy's linspace truncates to the same columns as
            # jnp.linspace(...).astype(int32).
            idx = torch.as_tensor(
                np.linspace(0, K - 1, cfg.N_samples_extra).astype(np.int64),
                device=dev)
        picked = (torch.gather(z_vals, 1, idx) if idx.dim() == 2
                  else z_vals[:, idx.long()])
        z_extra = torch.cat([near_col, far_col, picked], dim=-1)
    else:
        z_extra = torch.cat([near_col, far_col], dim=-1)

    z_final = torch.sort(torch.cat([samples, z_extra], dim=-1), dim=-1).values

    # Random near-surface z for the eikonal loss.
    if jitter is not None:
        eik_idx = jitter["eik_idx"]
    else:
        eik_idx = torch.randint(0, z_final.shape[-1], (R, 1), generator=gen,
                                device=dev)
    z_samples_eik = torch.gather(z_final, -1, eik_idx.long())

    z_bg = None
    if cfg.inverse_sphere_bg:
        # Inverse depths of the background, uniform in [0, 1] scaled by 1/r.
        z_bg = uniform_z_vals(
            gen, RaySamplerConfig(near=0.0), ray_dirs, cam_loc, 1.0,
            cfg.N_samples_inverse_sphere, training, False, 1.0,
            t_rand=None if jitter is None else jitter["t_rand_bg"])
        z_bg = z_bg * (1.0 / scene_bounding_sphere)

    return SamplerOutput(z_final, z_samples_eik, z_bg, conv_iter)
