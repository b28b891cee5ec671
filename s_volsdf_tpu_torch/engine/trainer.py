"""Per-scene VolSDF trainer (counterpart of
s_volsdf_tpu/engine/trainer.py:41-77, 124-224, 290-443).

The JAX package runs a chunk of steps as one `lax.scan` program; here a
chunk is a Python loop over eager steps (`make_scan_train_fn`). A run
reads the MVS volumes in `train.mvs_pack_dtype` (stored so once per
run), through the cost-mapping kernel's copy of them, which lives for
that run only; the feedback render runs in
`train.feedback_render_dtype`.

Given a run directory (`exps_root` and `scan`), a trainer keeps the JAX
trainer's layout, {exps_root}/{exps_folder}/{expname}_{scan[4:]}/
{timestamp}/ with run.yaml, plots/ and checkpoints/, and its schedule:
checkpoint "latest" every 50 chunks and at the end of a run,
"epoch_<n>" every `train.checkpoint_freq` x (training views) steps and
at the end, and a quarter-resolution render of an eval view into plots/
every `train.render_freq` x (training views) steps. `is_continue`
takes the newest timestamp and resumes from its "latest": parameters,
Adam, iter_step, epoch, and the pixel/sampler generator
(`utils/checkpoint.py`; a JAX checkpoint, which has no torch generator,
reseeds it). Without a run directory nothing is written.

Lockstep multi-scene training (engine/multiscene.py) runs S trainers'
states as one stacked state (`stack_states`) through
`make_multiscene_train_fn`'s loop, each scene drawing from its own
trainer's generator, and hands each trainer its scene back
(`VolTrainer.take_scene`).

Under a process group (parallel/), every rank of the node holds the
trainer and runs the same program. With parallel.shard_rays and more
than one rank the loop is the ray-sharded one
(parallel.train_parallel.make_sharded_scan_train_fn; a num_pixels that
the ranks do not divide logs a warning and runs the single-rank loop, as
the JAX trainer does); the renders shard their rays over
`parallel.mesh.eval_group`. Only the node's first rank writes the run
directory, its checkpoints, plots and TensorBoard logs. A sharded run's
checkpoint is a one-process run's: the replicas are equal and the one
generator they share reproduces every rank's draws.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.config import Config, check_ported, save_config
from s_volsdf_tpu_torch.data.io import write_png
from s_volsdf_tpu_torch.data.scene_dataset import SceneData
from s_volsdf_tpu_torch.engine.render import render_depth, render_image
from s_volsdf_tpu_torch.engine.train_step import (Optimizer,
                                                  StackedOptimizer,
                                                  TrainState,
                                                  init_train_state,
                                                  make_multiscene_one_step,
                                                  make_one_step,
                                                  make_optimizer,
                                                  pack_for_chunk)
from s_volsdf_tpu_torch.models.loss import LossOutput
from s_volsdf_tpu_torch.models.network import (init_volsdf_params,
                                               stack_params)
from s_volsdf_tpu_torch.models.network_bg import init_volsdf_bg_params
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes
from s_volsdf_tpu_torch.parallel.mesh import (eval_group, is_writer,
                                              make_group, node_group)
from s_volsdf_tpu_torch.utils import checkpoint as ckpt
from s_volsdf_tpu_torch.utils.tracing import PhaseTimer, TBWriter
from s_volsdf_tpu_torch.utils.viz import stacked_panel

logger = logging.getLogger("s_volsdf_tpu_torch")


def make_scan_train_fn(cfg: Config, tx: Optimizer, *, use_mvs: bool,
                       n_views: int, img_res: Tuple[int, int],
                       n_rays: Optional[int] = None, group=None):
    """A function running `n_steps` optimisation steps with on-device
    pixel sampling; returns the state, each step's LossOutput and each
    step's host seconds (a step ends in the NaN guard's host sync, so
    that is its device time plus host overhead). `n_rays` and `group`:
    the rays sharded over a group of ranks (`make_one_step`;
    parallel.train_parallel.make_sharded_scan_train_fn)."""
    one_step = make_one_step(cfg, tx, use_mvs=use_mvs, n_views=n_views,
                             img_res=img_res, n_rays=n_rays, group=group)

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

    run_chunk.group = group
    return run_chunk


def make_multiscene_train_fn(cfg: Config, tx: StackedOptimizer, *,
                             use_mvs: bool, n_views: int,
                             img_res: Tuple[int, int],
                             n_rays: Optional[int] = None, group=None):
    """`make_scan_train_fn` for S scenes in lockstep (counterpart of
    s_volsdf_tpu/engine/trainer.py:80-115, which vmaps the scan over a
    leading scene axis): a function running `n_steps` lockstep steps of
    a stacked state (`stack_states`) on the S scenes' tensors
    (`VolTrainer.scene_tensors`) and SceneVolumes, each scene drawing
    from its own generator; returns the state, each step's LossOutput
    ((S,) fields) and each step's host seconds. `n_rays` and `group`:
    each scene's rays sharded over a group of ranks
    (`make_multiscene_one_step`)."""
    one_step = make_multiscene_one_step(cfg, tx, use_mvs=use_mvs,
                                        n_views=n_views, img_res=img_res,
                                        n_rays=n_rays, group=group)

    def run_chunk(state: TrainState, n_steps: int, scenes: List[Dict],
                  mvs, gens: List[torch.Generator]
                  ) -> Tuple[TrainState, List[LossOutput], List[float]]:
        losses, seconds = [], []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            state, lo = one_step(scenes, mvs, state, gens)
            seconds.append(time.perf_counter() - t0)
            losses.append(lo)
        return state, losses, seconds

    return run_chunk


def stack_states(states: List[TrainState]) -> TrainState:
    """S scenes' TrainStates as one: the parameters stacked
    (`stack_params`), their Adam states in a StackedOptimizer, and the
    common iter_step (the scenes advance in lockstep; states at
    different steps raise)."""
    steps = {st.iter_step for st in states}
    if len(steps) != 1:
        raise ValueError(f"stack_states: the scenes are at steps {steps}; "
                         f"lockstep training takes scenes at one step")
    params = stack_params([st.params for st in states])
    tx = StackedOptimizer.from_optimizers(
        list(params.parameters()), [st.opt_state for st in states])
    return TrainState(params, tx, steps.pop())


def _put(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _host_losses(lo: LossOutput) -> LossOutput:
    return LossOutput(*(None if x is None else float(x) for x in lo))


class VolTrainer:
    """Per-scene optimiser on one device; with `exps_root` (and `scan`,
    "scan<id>") it writes the run directory, its checkpoints and plots,
    and with `is_continue` resumes from the newest run's "latest"."""

    def __init__(self, cfg: Config, scene: SceneData,
                 scan: Optional[str] = None, *, device,
                 exps_root: Optional[str] = None, is_continue: bool = False,
                 chunk_steps: int = 200):
        self.cfg = check_ported(cfg)
        self.scene = scene
        self.scan = scan
        self.device = torch.device(device)
        self.chunk_steps = chunk_steps
        self.stg = 2        # the cascade stage whose volumes are loaded
        self.writer = is_writer()   # this rank writes the run's files
        self.rundir = self.plots_dir = self.checkpoints_path = None
        if exps_root is not None:
            self._make_run_dir(exps_root, is_continue)
        elif is_continue:
            raise ValueError("is_continue needs a run directory (exps_root)")
        init = (init_volsdf_bg_params if cfg.model.with_background
                else init_volsdf_params)
        params = init(torch.Generator().manual_seed(cfg.seed), cfg.model,
                      self.device)
        self.tx = make_optimizer(cfg, params)
        self.state = init_train_state(cfg, params, self.tx)
        self.epoch = 0
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed + 1)
        if is_continue:
            self.load_checkpoint()
        self.trains_i = scene.trains_ids()
        self.scale_factor = scene.scale_factor
        self.mvs: Optional[MVSVolumes] = None
        self.losses: List[LossOutput] = []   # every step of the last run
        self.chunk_seconds: List[float] = []  # each chunk of the last run
        self.step_seconds: List[float] = []   # each step of the last run
        self.last_guard_trips = 0   # steps the NaN guard skipped, last run
        self.tb = TBWriter(self.plots_dir and self.writer
                           and os.path.join(self.plots_dir, "logs"))
        self.timer = PhaseTimer()

    def _make_run_dir(self, exps_root: str, is_continue: bool) -> None:
        if self.scan is None:
            raise ValueError("a run directory needs the scan's name")
        expname = f"{self.cfg.train.expname}_{self.scan[4:]}"
        expdir = os.path.join(exps_root, self.cfg.exps_folder, expname)
        timestamp = "{:%Y_%m_%d_%H_%M_%S}".format(datetime.now())
        if is_continue and os.path.isdir(expdir) and os.listdir(expdir):
            timestamp = sorted(os.listdir(expdir))[-1]
        self.rundir = os.path.join(expdir, timestamp)
        self.plots_dir = os.path.join(self.rundir, "plots")
        self.checkpoints_path = os.path.join(self.rundir, "checkpoints")
        if not self.writer:
            return
        os.makedirs(self.plots_dir, exist_ok=True)
        os.makedirs(self.checkpoints_path, exist_ok=True)
        save_config(self.cfg, os.path.join(self.rundir, "run.yaml"))

    # ---------------- checkpoints ----------------

    def save_checkpoint(self, label: str = "latest") -> str:
        """Write checkpoints/<label>: the state in the JAX TrainState's
        leaf order, the generator's state beside it (`torch_gen`, which
        JAX does not read) and the epoch. Returns its directory. On a
        rank other than the node's first this writes nothing."""
        if self.checkpoints_path is None:
            raise RuntimeError("save_checkpoint: the trainer has no run "
                               "directory (exps_root)")
        path = os.path.join(self.checkpoints_path, label)
        if not self.writer:
            return path
        ckpt.save_state(path, ckpt.train_state_leaves(self.state),
                        backend=self.cfg.train.ckpt_backend,
                        extras={"torch_gen": self.gen.get_state().numpy()},
                        epoch=self.epoch, torch_gen_device=self.device.type)
        return path

    def load_checkpoint(self, label: str = "latest") -> None:
        """Resume from checkpoints/<label> when it exists. A checkpoint
        without this device type's generator state (a JAX one, or one
        from another device type) reseeds the generator from seed + 1."""
        path = os.path.join(self.checkpoints_path, label)
        if not os.path.exists(path):
            return
        leaves, extras, meta = ckpt.load_state(
            path, ckpt.train_state_leaves(self.state))
        ckpt.restore_train_state(self.state, leaves)
        self.epoch = meta.get("epoch", 0)
        if ("torch_gen" in extras
                and meta.get("torch_gen_device") == self.device.type):
            self.gen.set_state(torch.as_tensor(extras["torch_gen"]))
        else:
            self.gen.manual_seed(self.cfg.seed + 1)
            logger.info(f"{path} holds no {self.device.type} generator "
                        f"state: generator reseeded from seed + 1")
        logger.info(f"resumed from {path} at step {self.state.iter_step}")

    def _snapshot(self, label: str = "latest") -> None:
        """The checkpoint of the schedule; under a process group every
        rank waits until the first has written it, so that none reads a
        checkpoint in the making."""
        if self.checkpoints_path is not None:
            self.save_checkpoint(label)
            group = node_group()
            if group is not None:
                group.barrier()

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

    def scene_tensors(self) -> Dict[str, torch.Tensor]:
        """The training views' rgb, rgb_smooth (V, H*W, 3), poses and
        intrinsics (V, 4, 4) on the trainer's device."""
        ti = self.trains_i
        return {k: _put(getattr(self.scene, k)[ti], self.device)
                for k in ("rgb", "rgb_smooth", "poses", "intrinsics")}

    def take_scene(self, stacked: TrainState, s: int) -> None:
        """Scene s of a lockstep run's stacked state into this trainer:
        its parameters (copied into the trainer's own), its Adam moments
        and count (`StackedOptimizer.write_back`) and iter_step."""
        with torch.no_grad():
            for mine, p in zip(self.state.params.parameters(),
                               stacked.params.parameters()):
                mine.copy_(p[s])
        stacked.opt_state.write_back(s, self.tx)
        self.state.iter_step = stacked.iter_step

    def _get_loop(self, use_mvs: bool):
        """The single-rank loop, or the ray-sharded one when
        parallel.shard_rays is set and the mesh's first axis holds more
        than one rank (counterpart of the JAX trainer's `_build_loop`).
        Both take (state, n_steps, scene, mvs, gen)."""
        cfg, pcfg = self.cfg, self.cfg.parallel
        mesh = make_group(pcfg.mesh_shape, pcfg.mesh_axes)
        kw = dict(use_mvs=use_mvs, n_views=len(self.trains_i),
                  img_res=self.scene.img_res)
        if (pcfg.shard_rays and mesh is not None and mesh.size > 1
                and mesh.coords is not None):
            axis = pcfg.mesh_axes[0]
            n = mesh.shape[axis]
            if cfg.train.num_pixels % n == 0:
                from s_volsdf_tpu_torch.parallel.train_parallel import (
                    make_sharded_scan_train_fn)
                logger.info(f"ray-sharded training over {n} ranks "
                            f"({cfg.train.num_pixels} rays/step, "
                            f"{cfg.train.num_pixels // n} per rank)")
                return make_sharded_scan_train_fn(
                    cfg, self.tx, mesh.group(axis), axis=axis, **kw)
            logger.warning(
                f"parallel.shard_rays set but train.num_pixels="
                f"{cfg.train.num_pixels} is not divisible by {n} "
                f"devices; falling back to single-device loop")
        return make_scan_train_fn(cfg, self.tx, **kw)

    def run(self, opt_stepN: int, log_every: int = 1000) -> int:
        """Optimise for opt_stepN steps; returns the epoch counter (an
        epoch is one pass over the training views). With a run
        directory, writes the checkpoints and plot renders of the
        schedule in the module docstring."""
        use_mvs = bool(self.cfg.use_mvs and self.mvs is not None)
        mvs = None
        if use_mvs:   # the volumes in mvs_pack_dtype, once per run; the
            # kernel's copy of them (8x their bytes) is this run's alone
            mvs = pack_for_chunk(self.cfg, self.mvs)
            self.mvs = dataclasses.replace(mvs, kernel=None)
        ti = self.trains_i
        n_views = max(len(ti), 1)
        run_chunk = self._get_loop(use_mvs)
        scene_dev = self.scene_tensors()
        start = self.state.iter_step
        done = 0
        guard_trips = 0
        self.losses = []
        self.chunk_seconds = []
        self.step_seconds = []
        next_log = log_every
        snap_every = max(self.cfg.train.checkpoint_freq * len(ti), 1)
        next_snap = snap_every
        render_every = max(self.cfg.train.render_freq * len(ti), 1)
        next_render = (render_every if self.cfg.train.render_freq > 0
                       and self.plots_dir is not None else -1)
        while done < opt_stepN:
            n = min(self.chunk_steps, opt_stepN - done)
            t0 = time.perf_counter()
            self.state, losses, seconds = run_chunk(
                self.state, n, scene_dev, mvs, self.gen)
            # Host time of the chunk; every step ends in the guard's
            # host sync, so this is the device time plus host overhead.
            self.chunk_seconds.append(time.perf_counter() - t0)
            self.step_seconds += seconds
            losses = [_host_losses(lo) for lo in losses]
            self.losses += losses
            done += n
            step_now = start + done
            lo = losses[-1]
            for name in ("loss", "rgb_loss", "eikonal_loss", "mvs_loss",
                         "sparse_loss", "psnr"):
                self.tb.scalar(f"t/{name}", getattr(lo, name), step_now)
            beta = abs(float(self.state.params.density.beta.detach()))
            self.tb.scalar("t/beta", beta, step_now)
            self.tb.scalar("t/alpha", 1.0 / max(beta, 1e-8), step_now)
            guard_trips += sum(x.grad_finite == 0.0 for x in losses)
            self.tb.scalar("t/guard_trips", guard_trips, step_now)
            self.last_guard_trips = guard_trips
            if done >= next_log or done >= opt_stepN:
                logger.info(f"step {step_now}: loss={lo.loss:.4f} "
                            f"rgb={lo.rgb_loss:.4f} eik={lo.eikonal_loss:.4f} "
                            f"mvs={lo.mvs_loss:.4f} psnr={lo.psnr:.2f}")
                next_log += log_every
            if next_render >= 0 and done >= next_render:
                self._plot_render(step_now)
                next_render += render_every
            if done >= next_snap:
                self._snapshot(f"epoch_{step_now // n_views}")
                next_snap = (done // snap_every + 1) * snap_every
            if (done // max(self.chunk_steps, 1)) % 50 == 0:
                self._snapshot()
        self.epoch += max(1, opt_stepN // n_views)
        self._snapshot()
        self._snapshot(f"epoch_{self.epoch}")
        return self.epoch

    def _plot_render(self, step: int) -> None:
        """A quarter-resolution render of the first eval view (else the
        first training view) as plots/render_<step>.png: [GT | render |
        depth | normal]."""
        eval_ids = self.scene.eval_ids()
        vid = eval_ids[0] if eval_ids else self.trains_i[0]
        with self.timer.phase("plot_render"):
            maps = self.render_view(vid, res_scale=0.25, fast=-1)
        if not self.writer:
            return
        H4, W4 = maps["rgb"].shape[:2]
        gt = self.scene.rgb[vid].reshape(*self.scene.img_res, 3)
        gt4 = gt[::4, ::4][:H4, :W4]
        panel = stacked_panel(gt4, maps["rgb"], maps["depth"],
                              maps["normal"], maps["acc"])
        self.tb.image("val/vis", panel, step)
        write_png(os.path.join(self.plots_dir, f"render_{step}.png"),
                  (np.clip(panel, 0, 1) * 255).astype(np.uint8))
        mse = float(np.mean((maps["rgb"] - gt4) ** 2))
        self.tb.scalar("val/psnr", -10.0 * np.log10(max(mse, 1e-10)), step)

    def render_view(self, view_idx: int, *, res_scale: float = 1.0,
                    fast: int = -1) -> Dict[str, np.ndarray]:
        """rgb, depth, normal and acc of a view (`render_image`) in the
        model's precision, with a background model through the nearest
        training view's directions; res_scale < 1 renders a reduced
        grid."""
        H, W = self.scene.img_res
        out_res = (int(H * res_scale), int(W * res_scale))
        intr = np.array(self.scene.intrinsics[view_idx], np.float32)
        intr[0, :] *= res_scale
        intr[1, :] *= res_scale
        return render_image(self.state.params, self.cfg.model,
                            self.scene.poses[view_idx], intr, out_res,
                            chunk=16384, fast=fast, device=self.device,
                            near_pose=self.scene.near_pose(view_idx),
                            group=eval_group(self.cfg.parallel, 16384))

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
        with self.timer.phase("render_mvs"):
            maps = render_depth(self.state.params, mcfg,
                                self.scene.poses[view_idx], intr, out_res,
                                fast=-1, chunk=chunk, device=self.device,
                                group=eval_group(self.cfg.parallel, chunk))
        depth = maps["depth"] * self.scale_factor
        far = depth.max()
        depth = np.where(maps["acc"] < 0.2, far, depth)
        return depth.astype(np.float32)
