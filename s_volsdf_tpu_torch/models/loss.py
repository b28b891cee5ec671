"""VolSDF training loss: RGB L1 + eikonal + MVS GCE + sparsity with the
RGB anneal, and the optional gate rescue (counterpart of
s_volsdf_tpu/models/loss.py:19-156).

With `scenes=S` (the lockstep multi-scene step) the outputs hold S
scenes' rays one scene after another (the eikonal gradients each
scene's 2N together) and every term is that scene's own mean: the
fields of LossOutput are (S,), as under the JAX package's `vmap`."""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch

from s_volsdf_tpu_torch.config import LossConfig


def _mean(x: torch.Tensor, S: int) -> torch.Tensor:
    """The mean of x, or with S scenes (x's leading axis holding them one
    after another) each scene's mean, (S,)."""
    return torch.mean(x) if not S else x.reshape(S, -1).mean(dim=1)


class LossOutput(NamedTuple):
    loss: torch.Tensor
    rgb_loss: torch.Tensor
    eikonal_loss: torch.Tensor
    mvs_loss: torch.Tensor
    sparse_loss: torch.Tensor
    psnr: torch.Tensor
    # The gate-rescue term (zero with loss.gate_rescue off).
    rescue_loss: Optional[torch.Tensor] = None
    # 1.0 when the NaN/Inf guard accepted the update, 0.0 when it
    # skipped it (set by engine.train_step.guarded_update).
    grad_finite: Optional[float] = None


def _rgb_l1(rgb_values, rgb_gt, S=0):
    return _mean(torch.abs(rgb_values - rgb_gt), S)


def _rgb_l1_gated(rgb_values, rgb_gt, pi, pj, t, S=0):
    """L1 against the blurred GT on low-confidence rays only."""
    confi = torch.sum(pi * pj, dim=-1)
    per_ray = torch.mean(torch.abs(rgb_values - rgb_gt), dim=-1)
    return _mean(per_ray * (confi < t), S)


def _eikonal(grad_theta, S=0):
    return _mean((torch.linalg.norm(grad_theta, dim=1) - 1.0) ** 2, S)


def _mvs_gce(pi, pj, w, gce: float, confi_thresh: float, S=0):
    """Generalised cross-entropy against the MVS probability volume."""
    pw = pi * pj
    if gce == 1.0:
        per_sample = -pw * w
    elif gce == 0.0:
        per_sample = -pw * torch.log(w + 1e-8)
    else:
        per_sample = -pw * w.detach() ** gce * torch.log(w + 1e-8)
    per_ray = torch.sum(per_sample, dim=1)
    gate = (torch.sum(pw, dim=1) > confi_thresh).to(per_ray.dtype)
    return _mean(gate * per_ray, S)


def _sparse(pi, pj, depth, confi_thresh: float, S=0):
    """Penalise small depth on low-confidence rays."""
    confi = torch.sum(pi * pj, dim=-1)
    per_ray = 1.0 / (depth.squeeze() + 1e-3)
    return _mean(per_ray * (confi < confi_thresh), S)


def _gate_rescue(pi, pj, depth, anchor, peak, confi_thresh: float,
                 peak_thresh: float, S=0):
    """L1 of the rendered depth to the prior's winner-take-all depth, on
    rays whose GCE gate is closed (sum pi*pj <= confi) and whose prior
    peaks above peak_thresh; zero on every other ray."""
    conf = torch.sum(pi * pj, dim=-1)
    closed = (conf <= confi_thresh).to(depth.dtype)
    informative = (peak > peak_thresh).to(depth.dtype)
    per_ray = torch.abs(depth.squeeze() - anchor)
    return _mean(closed * informative * per_ray, S)


def compute_loss(cfg: LossConfig, outputs: Dict, rgb_gt, rgb_smooth,
                 iter_step: int, *, use_mvs: bool,
                 scenes: int = 0) -> LossOutput:
    """Total loss. outputs: rgb_values, grad_theta, weights,
    depth_values, with a background model depth_values_all (which the
    sparse and rescue terms read in place of depth_values), with use_mvs
    pi and pj from cost_mapping, and with loss.gate_rescue prior_anchor
    and prior_peak (`ops.cost_mapping.prior_depth_anchor`).
    iter_step: the step count (a Python int) that drives the anneal.
    scenes: S for S scenes' rays one scene after another, each term per
    scene ((S,) fields), or 0."""
    S = scenes
    rgb_gt = rgb_gt.reshape(-1, 3)
    rgb_values = outputs["rgb_values"]

    rgb_loss = _rgb_l1(rgb_values, rgb_gt, S)
    eik_loss = _eikonal(outputs["grad_theta"], S)

    zero = torch.zeros((S,) if S else (), dtype=rgb_loss.dtype,
                       device=rgb_loss.device)
    mvs_loss = zero
    sparse_loss = zero
    anneal_sparse = zero
    if use_mvs and cfg.mvs_weight > 0.0:
        mvs_loss = _mvs_gce(outputs["pi"], outputs["pj"], outputs["weights"],
                            cfg.gce, cfg.confi, S)

    anneal_active = (cfg.sparse_weight > 0.0) and (cfg.anneal_rgb > 0)
    depth = outputs.get("depth_values_all", outputs["depth_values"])
    if use_mvs and anneal_active and iter_step < cfg.anneal_rgb:
        sparse_loss = _sparse(outputs["pi"], outputs["pj"], depth, cfg.confi,
                              S)
        # Linear 1 -> 0 decay over anneal_rgb steps.
        t = torch.tensor(iter_step, dtype=torch.float32) / cfg.anneal_rgb
        anneal_sparse = torch.clamp(1.0 - t, min=0.0).to(rgb_loss.device)
        # During the anneal the RGB target is the blurred GT, gated to
        # low-confidence rays.
        rgb_loss = _rgb_l1_gated(rgb_values, rgb_smooth.reshape(-1, 3),
                                 outputs["pi"], outputs["pj"], t=1e-8, S=S)

    rescue_loss = zero
    if use_mvs and cfg.gate_rescue:
        rescue_loss = _gate_rescue(
            outputs["pi"], outputs["pj"], depth, outputs["prior_anchor"],
            outputs["prior_peak"], cfg.confi, cfg.gate_rescue_peak, S)

    total = (cfg.rgb_weight * rgb_loss
             + cfg.eikonal_weight * eik_loss
             + cfg.mvs_weight * mvs_loss
             + cfg.sparse_weight * anneal_sparse * sparse_loss)
    if use_mvs and cfg.gate_rescue:
        # Added only with the flag on, so the default path's sum is as
        # without it.
        total = total + cfg.gate_rescue_weight * rescue_loss

    mse = _mean((rgb_values - rgb_gt) ** 2, S)
    psnr = -10.0 * torch.log(mse) / math.log(10.0)

    return LossOutput(total, rgb_loss, eik_loss, mvs_loss, sparse_loss, psnr,
                      rescue_loss)
