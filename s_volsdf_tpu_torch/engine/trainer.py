"""Per-scene VolSDF trainer (counterpart of
s_volsdf_tpu/engine/trainer.py:41-77, 124-224, 290-375, 422-443).

The JAX package runs a chunk of steps as one `lax.scan` program; here a
chunk is a Python loop over eager steps (`make_scan_train_fn`). A run
reads the MVS volumes in `train.mvs_pack_dtype` (stored so once per
run), through the cost-mapping kernel's copy of them, which lives for
that run only; the feedback render runs in
`train.feedback_render_dtype`. Not ported yet: TensorBoard scalars,
plot renders and checkpoints.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.config import Config, check_ported
from s_volsdf_tpu_torch.data.scene_dataset import SceneData
from s_volsdf_tpu_torch.engine.render import render_depth
from s_volsdf_tpu_torch.engine.train_step import (Optimizer, TrainState,
                                                  init_train_state,
                                                  make_one_step,
                                                  make_optimizer,
                                                  pack_for_chunk)
from s_volsdf_tpu_torch.models.loss import LossOutput
from s_volsdf_tpu_torch.models.network import init_volsdf_params
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes

logger = logging.getLogger("s_volsdf_tpu_torch")


def make_scan_train_fn(cfg: Config, tx: Optimizer, *, use_mvs: bool,
                       n_views: int, img_res: Tuple[int, int]):
    """A function running `n_steps` optimisation steps with on-device
    pixel sampling; returns the state, each step's LossOutput and each
    step's host seconds (a step ends in the NaN guard's host sync, so
    that is its device time plus host overhead)."""
    one_step = make_one_step(cfg, tx, use_mvs=use_mvs, n_views=n_views,
                             img_res=img_res)

    def run_chunk(state: TrainState, n_steps: int, scene: Dict,
                  mvs: Optional[MVSVolumes], gen: torch.Generator
                  ) -> Tuple[TrainState, List[LossOutput], List[float]]:
        losses, seconds = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            state, lo = one_step(scene, mvs, state, gen)
            seconds.append(time.perf_counter() - t0)
            losses.append(lo)
        return state, losses, seconds

    return run_chunk


def _put(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _host_losses(lo: LossOutput) -> LossOutput:
    return LossOutput(*(float(x) for x in lo))


class VolTrainer:
    """Per-scene optimiser on one device."""

    def __init__(self, cfg: Config, scene: SceneData, *, device,
                 chunk_steps: int = 200):
        self.cfg = check_ported(cfg)
        self.scene = scene
        self.device = torch.device(device)
        self.chunk_steps = chunk_steps
        self.stg = 2        # the cascade stage whose volumes are loaded
        params = init_volsdf_params(torch.Generator().manual_seed(cfg.seed),
                                    cfg.model, self.device)
        self.tx = make_optimizer(cfg, params)
        self.state = init_train_state(cfg, params, self.tx)
        self.epoch = 0
        self.trains_i = scene.trains_ids()
        self.scale_factor = scene.scale_factor
        self.mvs: Optional[MVSVolumes] = None
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        self.losses: List[LossOutput] = []   # every step of the last run
        self.chunk_seconds: List[float] = []  # each chunk of the last run
        self.step_seconds: List[float] = []   # each step of the last run

    def get_mvs_input(self, outs: List[Dict]) -> MVSVolumes:
        """Stack the cascade's per-view prob volumes and hypothesis slabs
        (outs[i]["prob_volume"], ["depth_values"], (D, Hc, Wc) tensors)
        into MVSVolumes, on the device they are on: depths in the
        trainer's units (/ scale_factor), the near plane clamped to the
        bounding sphere's radius. `run` stores the probabilities in
        train.mvs_pack_dtype."""
        r = self.cfg.model.scene_bounding_sphere
        probs, slabs = [], []
        for out in outs:
            dvals = out["depth_values"] / self.scale_factor
            probs.append(out["prob_volume"])
            slabs.append(torch.stack([torch.clamp(dvals[0], max=r),
                                      dvals[-1]], dim=0))
        ti = self.trains_i
        dev = probs[0].device
        self.mvs = MVSVolumes(
            prob=torch.stack(probs), z_slab=torch.stack(slabs),
            intrinsics=_put(self.scene.intrinsics[ti], dev),
            c2w=_put(self.scene.poses[ti], dev), img_res=self.scene.img_res,
            inverse_depth=bool(self.cfg.inverse_depth) and self.stg == 0)
        return self.mvs

    def run(self, opt_stepN: int, log_every: int = 1000) -> int:
        """Optimise for opt_stepN steps; returns the epoch counter (an
        epoch is one pass over the training views)."""
        use_mvs = bool(self.cfg.use_mvs and self.mvs is not None)
        mvs = None
        if use_mvs:   # the volumes in mvs_pack_dtype, once per run; the
            # kernel's copy of them (8x their bytes) is this run's alone
            mvs = pack_for_chunk(self.cfg, self.mvs)
            self.mvs = dataclasses.replace(mvs, kernel=None)
        ti = self.trains_i
        run_chunk = make_scan_train_fn(self.cfg, self.tx, use_mvs=use_mvs,
                                       n_views=len(ti),
                                       img_res=self.scene.img_res)
        scene_dev = {k: _put(getattr(self.scene, k)[ti], self.device)
                     for k in ("rgb", "rgb_smooth", "poses", "intrinsics")}
        start = self.state.iter_step
        done = 0
        self.losses = []
        self.chunk_seconds = []
        self.step_seconds = []
        next_log = log_every
        while done < opt_stepN:
            n = min(self.chunk_steps, opt_stepN - done)
            t0 = time.perf_counter()
            self.state, losses, seconds = run_chunk(
                self.state, n, scene_dev, mvs, self.gen)
            # Host time of the chunk; every step ends in the guard's
            # host sync, so this is the device time plus host overhead.
            self.chunk_seconds.append(time.perf_counter() - t0)
            self.step_seconds += seconds
            self.losses += [_host_losses(lo) for lo in losses]
            done += n
            if done >= next_log or done >= opt_stepN:
                lo = self.losses[-1]
                logger.info(f"step {start + done}: loss={lo.loss:.4f} "
                            f"rgb={lo.rgb_loss:.4f} eik={lo.eikonal_loss:.4f} "
                            f"mvs={lo.mvs_loss:.4f} psnr={lo.psnr:.2f}")
                next_log += log_every
        self.epoch += max(1, opt_stepN // max(len(ti), 1))
        return self.epoch

    def render_mvs(self, view_idx: int, res_scale: float = 1.0,
                   chunk: int = 16384) -> np.ndarray:
        """Depth of a training view for cascade feedback: depth *
        scale_factor, pixels with accumulated weight < 0.2 pushed to the
        far (largest) depth. res_scale < 1 renders a reduced grid. The
        MLP runs in bf16 when train.feedback_render_dtype is bfloat16
        (products and activations), else in the model's precision."""
        H, W = self.scene.img_res
        out_res = (int(H * res_scale), int(W * res_scale))
        intr = np.array(self.scene.intrinsics[view_idx], np.float32)
        intr[0, :] *= res_scale
        intr[1, :] *= res_scale
        mcfg = self.cfg.model
        if self.cfg.train.feedback_render_dtype == "bfloat16":
            mcfg = dataclasses.replace(mcfg, compute_dtype="bfloat16",
                                       activation_dtype="bfloat16")
        maps = render_depth(self.state.params, mcfg,
                            self.scene.poses[view_idx], intr, out_res,
                            fast=-1, chunk=chunk, device=self.device)
        depth = maps["depth"] * self.scale_factor
        far = depth.max()
        depth = np.where(maps["acc"] < 0.2, far, depth)
        return depth.astype(np.float32)
