"""The VolSDF optimisation step (counterpart of
s_volsdf_tpu/engine/train_step.py:43-217): forward (fast=1 sampler;
with model.with_background the NeRF++ background model,
`models.network_bg.render_rays_bg`), cost_mapping against the MVS
probability volumes (and, under loss.gate_rescue, the prior's anchor
depths), loss, backward with double backprop for the eikonal term,
NaN/Inf guard, global-norm clip, Adam.

The JAX package fuses the step into one XLA program; here it runs
eagerly, and the state is updated in place (parameters and Adam moments).
The guard reads one flag on the host per step.

Precision as in the JAX step: the render runs with
`train.train_compute_dtype` / `train_activation_dtype` in place of the
model's own (`training_model_config`), the MVS probability volumes are
read in `train.mvs_pack_dtype` (`pack_for_chunk`), and the loss, the
guard, the clip and Adam stay float32. Float32 products run in full
float32 on the card (`utils.device.full_float32`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from s_volsdf_tpu_torch.config import Config, ModelConfig, check_ported
from s_volsdf_tpu_torch.models.loss import LossOutput, compute_loss
from s_volsdf_tpu_torch.models.network import VolSDFParams, render_rays
from s_volsdf_tpu_torch.models.network_bg import render_rays_bg
from s_volsdf_tpu_torch.ops.cost_mapping import (MVSVolumes, check_volumes,
                                                 cost_mapping,
                                                 prior_depth_anchor)
from s_volsdf_tpu_torch.utils.device import full_float32


def training_model_config(cfg: Config) -> ModelConfig:
    """The model config the training render runs with: the training
    precision knobs in place of the model's own (eval and render paths
    keep model.compute_dtype / activation_dtype)."""
    return dataclasses.replace(
        cfg.model, compute_dtype=cfg.train.train_compute_dtype,
        activation_dtype=cfg.train.train_activation_dtype)


def pack_for_chunk(cfg: Config, mvs: Optional[MVSVolumes]
                   ) -> Optional[MVSVolumes]:
    """The volumes with their probabilities stored in
    `train.mvs_pack_dtype` (the near/far planes stay float32): the
    counterpart of the JAX package's pack, done once per chunked loop.
    They are validated for the cost-mapping kernel here, once, and carry
    its corner-block copy (`ops.cost_mapping.check_volumes`: 8x their
    bytes; the trainer drops it when its run ends). Returns `mvs` itself
    when it already has that dtype and that copy (or is None)."""
    if mvs is None:
        return None
    dtype = torch.bfloat16 if cfg.train.mvs_pack_dtype == "bfloat16" \
        else torch.float32
    if mvs.prob.dtype != dtype:
        mvs = dataclasses.replace(mvs, prob=mvs.prob.to(dtype))
    return check_volumes(mvs)


class Optimizer:
    """optax.chain(clip_by_global_norm(1.0), adam(lr)), in that order.

    The clip is optax's formula, not `clip_grad_norm_` (which adds 1e-6
    to the norm): g -> g / ||g|| * max_norm only when ||g|| >= max_norm.
    Adam is torch.optim.Adam, whose update matches optax.adam's (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root)."""

    def __init__(self, params: List[torch.nn.Parameter], lr: float,
                 clip_norm: Optional[float]):
        self.params = list(params)
        self.clip_norm = clip_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8)

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.clip_norm is None:
            return grads
        g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = g_norm < self.clip_norm
        return [torch.where(keep, g, (g / g_norm) * self.clip_norm)
                for g in grads]

    def apply(self, grads: List[torch.Tensor]) -> None:
        """Clip, then one Adam step, in place."""
        for p, g in zip(self.params, self.clip(grads)):
            p.grad = g
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)


def make_optimizer(cfg: Config, params: VolSDFParams) -> Optimizer:
    """Adam with the optional global-norm clip at 1.0."""
    return Optimizer(params.parameters(), cfg.train.learning_rate,
                     1.0 if cfg.train.grad_clip else None)


@dataclasses.dataclass
class TrainState:
    params: VolSDFParams
    opt_state: Optimizer
    iter_step: int


def init_train_state(cfg: Config, params: VolSDFParams, tx: Optimizer) -> TrainState:
    check_ported(cfg)
    return TrainState(params, tx, 0)


def _loss_fn(params: VolSDFParams, cfg: Config, batch: Dict, gen,
             mvs: Optional[MVSVolumes], iter_step: int
             ) -> Tuple[torch.Tensor, LossOutput]:
    # batch["jitter"]: the optional common-random-numbers feed of the
    # sampler and the eikonal points (models/sampler.py).
    render = render_rays_bg if cfg.model.with_background else render_rays
    out = render(params, training_model_config(cfg), batch["uv"],
                 batch["pose"], batch["intrinsics"], gen, training=True,
                 fast=1, jitter=batch.get("jitter"))
    outputs = {
        "rgb_values": out.rgb_values,
        "depth_values": out.depth_values,
        "weights": out.weights,
        "grad_theta": out.grad_theta,
    }
    if cfg.model.with_background:
        outputs["depth_values_all"] = out.depth_values_all
    use_mvs = mvs is not None
    if use_mvs:
        pj, pi, _ = cost_mapping(out.depth_vals.detach(), out.xyz.detach(),
                                 batch["view_onehot"], mvs)
        outputs["pi"], outputs["pj"] = pi, pj
        if cfg.loss.gate_rescue:
            outputs["prior_anchor"], outputs["prior_peak"] = \
                prior_depth_anchor(batch["uv"].reshape(-1, 2),
                                   batch["view_onehot"], mvs)
    loss_out = compute_loss(
        cfg.loss, outputs, batch["rgb"], batch.get("rgb_smooth", batch["rgb"]),
        iter_step, use_mvs=use_mvs)
    return loss_out.loss, loss_out


def loss_and_grads(params: VolSDFParams, cfg: Config, batch: Dict, gen,
                   mvs: Optional[MVSVolumes], iter_step: int
                   ) -> Tuple[List[torch.Tensor], LossOutput]:
    """Gradients of `_loss_fn` for every parameter, in
    `params.parameters()` order (float32 products in full float32)."""
    with full_float32():
        loss, loss_out = _loss_fn(params, cfg, batch, gen, mvs, iter_step)
        grads = torch.autograd.grad(loss, list(params.parameters()))
    return list(grads), loss_out


def guarded_update(tx: Optimizer, state: TrainState, grads: List[torch.Tensor],
                   loss_out: LossOutput) -> Tuple[TrainState, LossOutput]:
    """NaN/Inf guard + optimizer step.

    A non-finite gradient leaf or loss skips the update: parameters and
    Adam state (moments and step count) stay as they were. iter_step
    advances either way. The loss is checked too because |x - NaN| has a
    finite gradient. `grad_finite` reports 1.0 (applied) or 0.0 (skipped).
    """
    finite = torch.isfinite(loss_out.loss)
    for g in grads:
        finite = finite & torch.isfinite(g).all()
    ok = bool(finite.item())   # the step's one host sync
    if ok:
        tx.apply(grads)
    state.iter_step += 1
    loss_out = LossOutput(*(None if x is None else x.detach()
                            for x in loss_out[:-1]),
                          grad_finite=1.0 if ok else 0.0)
    return state, loss_out


def sample_train_batch(scene: Dict, gen: torch.Generator, *, n_views: int,
                       img_res: Tuple[int, int], n_rays: int) -> Dict:
    """One step's view and pixels, drawn on the device from `gen`.

    scene: rgb, rgb_smooth (V, H*W, 3), poses, intrinsics (V, 4, 4) on
    the device."""
    H, W = img_res
    dev = scene["rgb"].device
    view = torch.randint(0, n_views, (1,), generator=gen, device=dev)
    pix = torch.randint(0, H * W, (n_rays,), generator=gen, device=dev)
    ys = torch.div(pix, W, rounding_mode="floor").to(torch.float32)
    xs = (pix % W).to(torch.float32)
    uv = torch.stack([xs, ys], dim=-1)
    flat = view * (H * W) + pix
    return {
        "uv": uv[None],
        "rgb": scene["rgb"].reshape(-1, 3)[flat][None],
        "rgb_smooth": scene["rgb_smooth"].reshape(-1, 3)[flat][None],
        "pose": torch.index_select(scene["poses"], 0, view),
        "intrinsics": torch.index_select(scene["intrinsics"], 0, view),
        "view_onehot": F.one_hot(view[0], n_views).to(torch.float32),
    }


def make_one_step(cfg: Config, tx: Optimizer, *, use_mvs: bool, n_views: int,
                  img_res: Tuple[int, int], n_rays: Optional[int] = None):
    """The trainer's step: sample pixels on the device, grad, guard,
    update."""
    check_ported(cfg)
    n_rays = n_rays if n_rays is not None else cfg.train.num_pixels

    def one_step(scene: Dict, mvs: Optional[MVSVolumes], state: TrainState,
                 gen: torch.Generator) -> Tuple[TrainState, LossOutput]:
        batch = sample_train_batch(scene, gen, n_views=n_views,
                                   img_res=img_res, n_rays=n_rays)
        grads, loss_out = loss_and_grads(
            state.params, cfg, batch, gen, mvs if use_mvs else None,
            state.iter_step)
        return guarded_update(tx, state, grads, loss_out)

    return one_step


def train_step(state: TrainState, batch: Dict, gen, mvs: Optional[MVSVolumes],
               *, cfg: Config, tx: Optimizer, use_mvs: bool
               ) -> Tuple[TrainState, LossOutput]:
    """One step on a given batch: uv (B,N,2), pose (B,4,4),
    intrinsics (B,4,4), rgb (B,N,3), rgb_smooth (B,N,3), view_onehot (V,)
    and optionally "jitter". `mvs` is read in the dtype it has, as the
    JAX step reads what it is given (the trainer stores it with
    `pack_for_chunk`)."""
    check_ported(cfg)
    grads, loss_out = loss_and_grads(
        state.params, cfg, batch, gen, mvs if use_mvs else None,
        state.iter_step)
    return guarded_update(tx, state, grads, loss_out)
