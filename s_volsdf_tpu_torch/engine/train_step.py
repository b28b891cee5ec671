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

S scenes in lockstep (the counterpart of the JAX package's
`make_multiscene_train_fn`, which `vmap`s this step over a leading scene
axis): the parameters are stacked (`models.network.stack_params`), the
render takes the S scenes' batches at B = S, the cost mapping reads
`SceneVolumes` in one launch, the loss is per scene and the step
differentiates the sum of the S losses (the scenes share no parameter,
so each scene's gradient is its own loss's). `StackedOptimizer` guards,
clips and steps each scene on its own: a non-finite scene keeps its
parameters, its moments and its Adam count while the others step. Each
scene draws from its own generator in the serial step's order
(`draw_step_inputs`), so its pixels, views and sampler noise are a
serial run's. One host sync a step reads the S guard flags.

Rays sharded over a group of ranks (`group=` of `make_one_step` and
`make_multiscene_one_step`; the counterpart of the JAX step's
`shard_axis`): every rank draws the whole group's step from its
generator, which is alike on every rank (the same view, pixels and
sampler noise as one process drawing the group's rays), keeps its own
rows (`shard_batch`), and averages the gradients and the loss statistics
over the group (`mean_over_group`: one all_reduce each) before the
guard, which then decides alike on every rank. Every loss term is a
per-ray mean, so over equal shards the average is the whole batch's.
The generator's state, which a checkpoint saves, reproduces every
rank's draws.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.optim.adam import adam as adam_update

from s_volsdf_tpu_torch.config import Config, ModelConfig, check_ported
from s_volsdf_tpu_torch.models.loss import LossOutput, compute_loss
from s_volsdf_tpu_torch.models.network import (VolSDFParams, n_scenes,
                                               render_rays)
from s_volsdf_tpu_torch.models.network_bg import render_rays_bg
from s_volsdf_tpu_torch.ops.cost_mapping import (MVSVolumes, SceneVolumes,
                                                 check_volumes,
                                                 check_volumes_scenes,
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


class StackedOptimizer:
    """`Optimizer` for S scenes' stacked parameters (every leaf with a
    leading scene axis), each scene on its own, as the JAX package's
    `vmap` of clip + adam + guard:

      * the clip takes each scene's global norm (summing every leaf over
        every axis but the first) and applies optax's formula per scene;
      * Adam is torch.optim.Adam's own update (the functional
        `torch.optim.adam.adam`, on each scene's slice of each leaf, with
        torch's choice of its single-tensor or multi-tensor path), with a
        step count per scene and leaf, as torch keeps it (a CPU tensor),
        so the bias corrections are each scene's, computed on the host;
      * `apply` steps only the scenes whose flag is set: a skipped scene
        keeps its parameters, moments and count to the bit.

    `from_optimizers` starts from S serial `Optimizer`s' Adam states and
    `write_back` returns a scene's to one, so a scene moves between the
    lockstep loop and its serial trainer without losing its state."""

    def __init__(self, params: List[torch.nn.Parameter], lr: float,
                 clip_norm: Optional[float]):
        self.params = list(params)
        self.S = self.params[0].shape[0]
        self.lr = lr
        self.clip_norm = clip_norm
        self.exp_avg = [torch.zeros_like(p) for p in self.params]
        self.exp_avg_sq = [torch.zeros_like(p) for p in self.params]
        self.steps = [[torch.tensor(0.0) for _ in self.params]
                      for _ in range(self.S)]

    def count(self, s: int) -> int:
        """Scene s's Adam step count."""
        return int(self.steps[s][0])

    def clip(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        if self.clip_norm is None:
            return grads
        S = self.S
        sq = sum(torch.sum((g * g).reshape(S, -1), dim=1) for g in grads)
        g_norm = torch.sqrt(sq)
        keep = g_norm < self.clip_norm
        out = []
        for g in grads:
            shape = (S,) + (1,) * (g.dim() - 1)
            out.append(torch.where(keep.view(shape), g,
                                   (g / g_norm.view(shape)) * self.clip_norm))
        return out

    def apply(self, grads: List[torch.Tensor], ok: List[bool]) -> None:
        """Clip, then one Adam step of the scenes whose `ok` is True, in
        place."""
        grads = self.clip(grads)
        scenes = [s for s in range(self.S) if ok[s]]
        if not scenes:
            return
        with torch.no_grad():
            lists = [[t.detach()[s] for s in scenes for t in ts]
                     for ts in (self.params, grads, self.exp_avg,
                                self.exp_avg_sq)]
            steps = [st for s in scenes for st in self.steps[s]]
            adam_update(
                *lists, [], steps, foreach=None, capturable=False,
                differentiable=False, fused=None, grad_scale=None,
                found_inf=None, has_complex=False, amsgrad=False,
                beta1=0.9, beta2=0.999, lr=self.lr, weight_decay=0.0,
                eps=1e-8, maximize=False)

    @classmethod
    def from_optimizers(cls, params: List[torch.nn.Parameter],
                        optimizers: List[Optimizer]) -> "StackedOptimizer":
        """A StackedOptimizer of the stacked `params` holding each scene's
        `Optimizer` state (moments and count; none for a fresh one)."""
        first = optimizers[0]
        tx = cls(params, first.adam.defaults["lr"], first.clip_norm)
        with torch.no_grad():
            for s, opt in enumerate(optimizers):
                for l, p in enumerate(opt.params):
                    st = opt.adam.state.get(p, {})
                    if st:
                        tx.exp_avg[l][s] = st["exp_avg"]
                        tx.exp_avg_sq[l][s] = st["exp_avg_sq"]
                        tx.steps[s][l] = torch.tensor(float(st["step"]))
        return tx

    def write_back(self, s: int, opt: Optimizer) -> None:
        """Scene s's moments and count into a serial `Optimizer` of the
        same tree (as torch.optim.Adam keeps them; none at count 0)."""
        for l, p in enumerate(opt.params):
            count = float(self.steps[s][l])
            opt.adam.state.pop(p, None)
            if count > 0:
                opt.adam.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": self.exp_avg[l][s].detach().clone(),
                    "exp_avg_sq": self.exp_avg_sq[l][s].detach().clone()}


def make_stacked_optimizer(cfg: Config, params: VolSDFParams
                           ) -> StackedOptimizer:
    """`make_optimizer` for stacked parameters."""
    return StackedOptimizer(params.parameters(), cfg.train.learning_rate,
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
             mvs, iter_step: int) -> Tuple[torch.Tensor, LossOutput]:
    # batch["jitter"]: the optional common-random-numbers feed of the
    # sampler and the eikonal points (models/sampler.py); required, and
    # stacked, for S scenes (`stack_batches`), whose volumes are
    # SceneVolumes.
    S = n_scenes(params)
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
        xyz = out.xyz.detach()
        K = xyz.shape[1]
        if S:
            xyz = xyz.reshape(S, -1, K, 3)
        pj, pi, _ = cost_mapping(out.depth_vals.detach(), xyz,
                                 batch["view_onehot"], mvs)
        outputs["pi"], outputs["pj"] = pi.reshape(-1, K), pj.reshape(-1, K)
        if cfg.loss.gate_rescue:
            if S:
                anchors = [prior_depth_anchor(uv, onehot, m) for uv, onehot, m
                           in zip(batch["uv"], batch["view_onehot"],
                                  mvs.scenes)]
                outputs["prior_anchor"], outputs["prior_peak"] = (
                    torch.cat(a) for a in zip(*anchors))
            else:
                outputs["prior_anchor"], outputs["prior_peak"] = \
                    prior_depth_anchor(batch["uv"].reshape(-1, 2),
                                       batch["view_onehot"], mvs)
    loss_out = compute_loss(
        cfg.loss, outputs, batch["rgb"], batch.get("rgb_smooth", batch["rgb"]),
        iter_step, use_mvs=use_mvs, scenes=S)
    return loss_out.loss, loss_out


def loss_and_grads(params: VolSDFParams, cfg: Config, batch: Dict, gen,
                   mvs: Optional[MVSVolumes], iter_step: int
                   ) -> Tuple[List[torch.Tensor], LossOutput]:
    """Gradients of `_loss_fn` for every parameter, in
    `params.parameters()` order (float32 products in full float32); for
    S scenes' stacked parameters, of the sum of the S losses."""
    with full_float32():
        loss, loss_out = _loss_fn(params, cfg, batch, gen, mvs, iter_step)
        if n_scenes(params):
            loss = loss.sum()
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


def guarded_update_scenes(tx: StackedOptimizer, state: TrainState,
                          grads: List[torch.Tensor], loss_out: LossOutput
                          ) -> Tuple[TrainState, LossOutput]:
    """`guarded_update` per scene, for S scenes' stacked state: scene s
    steps when its loss and every leaf's slice s of the gradient are
    finite, else it keeps its parameters, moments and Adam count.
    iter_step (one for the S scenes, which advance in lockstep) advances
    either way. `grad_finite` is a tuple of the S flags (1.0 / 0.0);
    they come to the host in the step's one sync."""
    S = tx.S
    finite = torch.isfinite(loss_out.loss)
    for g in grads:
        finite = finite & torch.isfinite(g).reshape(S, -1).all(dim=1)
    ok = [bool(f) for f in finite.tolist()]   # the step's one host sync
    tx.apply(grads, ok)
    state.iter_step += 1
    loss_out = LossOutput(*(None if x is None else x.detach()
                            for x in loss_out[:-1]),
                          grad_finite=tuple(1.0 if f else 0.0 for f in ok))
    return state, loss_out


_RAY_KEYS = ("uv", "rgb", "rgb_smooth")


def shard_batch(batch: Dict, group) -> Dict:
    """This rank's rows of a batch of one scene's rays (`group.rows`):
    uv, rgb and rgb_smooth (B, N, ...) along N, and the jitter feed's
    per-ray draws along R; the view's tensors and the jitter feed's
    column picks (extra_idx) whole."""
    start, stop = group.rows(batch["uv"].shape[1])
    out = dict(batch)
    for k in _RAY_KEYS:
        out[k] = batch[k][:, start:stop]
    if "jitter" in batch:
        out["jitter"] = {k: v if k == "extra_idx" else v[start:stop]
                         for k, v in batch["jitter"].items()}
    return out


def sample_train_batch(scene: Dict, gen: torch.Generator, *, n_views: int,
                       img_res: Tuple[int, int], n_rays: int,
                       group=None) -> Dict:
    """One step's view and pixels, drawn on the device from `gen`; with
    a `group`, the group's n_rays x size pixels drawn and this rank's
    n_rays kept (`shard_batch`).

    scene: rgb, rgb_smooth (V, H*W, 3), poses, intrinsics (V, 4, 4) on
    the device."""
    if group is not None:
        return shard_batch(sample_train_batch(
            scene, gen, n_views=n_views, img_res=img_res,
            n_rays=n_rays * group.size), group)
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


def draw_step_inputs(scene: Dict, gen: torch.Generator, *, cfg: Config,
                     n_views: int, img_res: Tuple[int, int],
                     n_rays: int, group=None) -> Dict:
    """The serial training step's random draws from `gen`, in its order,
    as a batch with its jitter feed: the view and pixels
    (`sample_train_batch`), then the sampler's t_rand (R, N_samples_eval)
    and u_final (R, N_samples), the randperm of the N_samples_eval
    columns (its first N_samples_extra, "extra_idx"), eik_idx (R, 1),
    with a background model t_rand_bg (R, N_samples_inverse_sphere), and
    the eikonal points' U[0,1) "eik_pts" (R, 3). `train_step` on it
    does what `one_step(gen)` does, to the bit. With a `group`, the
    group's n_rays x size rays' draws, of which this rank keeps its
    n_rays (`shard_batch`)."""
    if group is not None:
        return shard_batch(draw_step_inputs(
            scene, gen, cfg=cfg, n_views=n_views, img_res=img_res,
            n_rays=n_rays * group.size), group)
    batch = sample_train_batch(scene, gen, n_views=n_views, img_res=img_res,
                               n_rays=n_rays)
    s = cfg.model.sampler
    dev = scene["rgb"].device

    def rand(n):
        return torch.rand((n_rays, n), generator=gen, dtype=torch.float32,
                          device=dev)

    jitter = {"t_rand": rand(s.N_samples_eval), "u_final": rand(s.N_samples)}
    n_final = s.N_samples + 2
    if s.N_samples_extra > 0:
        jitter["extra_idx"] = torch.randperm(
            s.N_samples_eval, generator=gen, device=dev)[: s.N_samples_extra]
        n_final += s.N_samples_extra
    jitter["eik_idx"] = torch.randint(0, n_final, (n_rays, 1), generator=gen,
                                      device=dev)
    if s.inverse_sphere_bg:
        jitter["t_rand_bg"] = rand(s.N_samples_inverse_sphere)
    jitter["eik_pts"] = rand(3)
    batch["jitter"] = jitter
    return batch


def stack_batches(batches: List[Dict]) -> Dict:
    """S scenes' batches (`draw_step_inputs`) as one batch at B = S: uv,
    rgb, rgb_smooth, pose, intrinsics (S, ...), view_onehot (S, V); the
    jitter feed's per-ray draws concatenated over the scenes' rays,
    extra_idx (S, N_extra)."""
    out = {k: torch.cat([b[k] for b in batches])
           for k in ("uv", "rgb", "rgb_smooth", "pose", "intrinsics")}
    out["view_onehot"] = torch.stack([b["view_onehot"] for b in batches])
    jit = [b["jitter"] for b in batches]
    out["jitter"] = {k: (torch.stack if k == "extra_idx" else torch.cat)(
        [j[k] for j in jit]) for k in jit[0]}
    return out


def mean_over_group(group, grads: List[torch.Tensor], loss_out: LossOutput
                    ) -> Tuple[List[torch.Tensor], LossOutput]:
    """The gradients and the loss statistics averaged over the group's
    ranks (lax.pmean): one all_reduce of every gradient flattened into
    one buffer, one more of the statistics."""
    grads = group.mean_flat(grads)
    fields = list(loss_out)
    present = [i for i, x in enumerate(fields[:-1]) if x is not None]
    stats = group.mean_flat([torch.stack([fields[i].detach()
                                          for i in present])])[0]
    for j, i in enumerate(present):
        fields[i] = stats[j]
    return grads, LossOutput(*fields)


def make_one_step(cfg: Config, tx: Optimizer, *, use_mvs: bool, n_views: int,
                  img_res: Tuple[int, int], n_rays: Optional[int] = None,
                  group=None):
    """The trainer's step: sample pixels on the device, grad, guard,
    update. With a `group` (parallel.mesh.Group), `n_rays` is this
    rank's share: the step draws the group's rays and their noise
    (`draw_step_inputs`), keeps this rank's, and averages the gradients
    and loss statistics over the group before the guard
    (`mean_over_group`)."""
    check_ported(cfg)
    n_rays = n_rays if n_rays is not None else cfg.train.num_pixels

    def one_step(scene: Dict, mvs: Optional[MVSVolumes], state: TrainState,
                 gen: torch.Generator) -> Tuple[TrainState, LossOutput]:
        mvs_in = mvs if use_mvs else None
        if group is None:
            batch = sample_train_batch(scene, gen, n_views=n_views,
                                       img_res=img_res, n_rays=n_rays)
            grads, loss_out = loss_and_grads(state.params, cfg, batch, gen,
                                             mvs_in, state.iter_step)
        else:
            batch = draw_step_inputs(scene, gen, cfg=cfg, n_views=n_views,
                                     img_res=img_res, n_rays=n_rays,
                                     group=group)
            grads, loss_out = mean_over_group(group, *loss_and_grads(
                state.params, cfg, batch, None, mvs_in, state.iter_step))
        return guarded_update(tx, state, grads, loss_out)

    return one_step


def make_multiscene_one_step(cfg: Config, tx: StackedOptimizer, *,
                             use_mvs: bool, n_views: int,
                             img_res: Tuple[int, int],
                             n_rays: Optional[int] = None, group=None):
    """The lockstep step of S scenes: each scene's draws from its own
    generator (`draw_step_inputs`), the stacked render, the per-scene
    loss and its gradients, the per-scene guard, clip and Adam. With a
    `group`, each scene's rays are sharded over it as in `make_one_step`
    (`n_rays` this rank's share)."""
    check_ported(cfg)
    n_rays = n_rays if n_rays is not None else cfg.train.num_pixels

    def one_step(scenes: List[Dict], mvs: Optional[SceneVolumes],
                 state: TrainState, gens: List[torch.Generator]
                 ) -> Tuple[TrainState, LossOutput]:
        batch = stack_batches([
            draw_step_inputs(sc, g, cfg=cfg, n_views=n_views,
                             img_res=img_res, n_rays=n_rays, group=group)
            for sc, g in zip(scenes, gens)])
        grads, loss_out = loss_and_grads(
            state.params, cfg, batch, None, mvs if use_mvs else None,
            state.iter_step)
        if group is not None:
            grads, loss_out = mean_over_group(group, grads, loss_out)
        return guarded_update_scenes(tx, state, grads, loss_out)

    return one_step


def pack_for_chunk_scenes(cfg: Config, volumes: List[MVSVolumes]
                          ) -> Tuple[List[MVSVolumes], SceneVolumes]:
    """S scenes' volumes with their probabilities in
    `train.mvs_pack_dtype`, and their stacked kernel copy
    (`check_volumes_scenes`, written one scene at a time): the lockstep
    counterpart of `pack_for_chunk`."""
    dtype = torch.bfloat16 if cfg.train.mvs_pack_dtype == "bfloat16" \
        else torch.float32
    stored = [dataclasses.replace(m, prob=m.prob.to(dtype), kernel=None)
              for m in volumes]
    return stored, check_volumes_scenes(stored)


def train_step(state: TrainState, batch: Dict, gen, mvs,
               *, cfg: Config, tx, use_mvs: bool
               ) -> Tuple[TrainState, LossOutput]:
    """One step on a given batch: uv (B,N,2), pose (B,4,4),
    intrinsics (B,4,4), rgb (B,N,3), rgb_smooth (B,N,3), view_onehot (V,)
    and optionally "jitter". `mvs` is read in the dtype it has, as the
    JAX step reads what it is given (the trainer stores it with
    `pack_for_chunk`). For S scenes' stacked state (`tx` a
    StackedOptimizer): a `stack_batches` batch and SceneVolumes, the
    per-scene guard (`guarded_update_scenes`)."""
    check_ported(cfg)
    grads, loss_out = loss_and_grads(
        state.params, cfg, batch, gen, mvs if use_mvs else None,
        state.iter_step)
    update = (guarded_update_scenes if isinstance(tx, StackedOptimizer)
              else guarded_update)
    return update(tx, state, grads, loss_out)
