"""Multi-scene training in lockstep on one GPU (counterpart of
s_volsdf_tpu/engine/multiscene.py:65-253): S per-scene VolSDF
optimisations advance together, each step one stacked step of the S
scenes (engine/train_step.make_multiscene_one_step), in place of the
serial per-scene loop of `engine.runner.save_depth`.

Per override group (scenes whose `per_scene_overrides` give the same
config: loss weights and inverse_depth are the step's), the frozen
cascade runs per scene, the VolSDF optimisations of the group run
jointly (`run_joint`), and the feedback renders and the outputs are per
scene again, as in the JAX package.

On the card the lockstep step's products and kernel launches take S
scenes at once: the fused-SDF sweep and the cost mapping are one launch
each for the S scenes. The serial step is launch-bound (about 3,000
launches a step against tens of ms of device work, PERF.md), and a
lockstep step makes about as many launches as one scene's, with S times
the rows in each. Each scene draws from its own trainer's generator in
the serial step's order, so its pixels, views and sampler noise are a
serial run's; its trajectory differs from the serial one only where a
batched product sums in another order than a single one (on the CPU
they agree to the bit; cuBLAS may differ at the last bit).

There is no fallback: a group the lockstep step cannot take (scenes of
different image sizes or volume shapes) raises, and nothing runs the
scenes serially in its place.

Under a process group (parallel/) every rank of the node holds every
scene's trainer, and `run_joint` spreads the scenes over the ranks as
the JAX package spreads them over its devices (`_pick_loop`): blocks of
scenes a rank, with no collective, when the ranks divide the scenes (or
one scene a rank when there are fewer scenes than ranks); each scene's
rays over its own line of ranks (a scene x rays mesh) when there are
spare ranks and parallel.shard_rays; else every rank runs every scene in
lockstep. Afterwards each scene's state is broadcast from the rank that
trained it, so every rank holds every scene again (the JAX package
unstacks its sharded states); the node's first rank writes the
checkpoints and the outputs.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional, Tuple

import torch

from s_volsdf_tpu_torch.config import Config, per_scene_overrides
from s_volsdf_tpu_torch.engine.train_step import pack_for_chunk_scenes
from s_volsdf_tpu_torch.engine.trainer import (VolTrainer,
                                               make_multiscene_train_fn,
                                               stack_states)
from s_volsdf_tpu_torch.models.loss import LossOutput
from s_volsdf_tpu_torch.ops.cost_mapping import SceneVolumes
from s_volsdf_tpu_torch.parallel.mesh import (Group, RankMesh, is_writer,
                                              make_group, node_group)
from s_volsdf_tpu_torch.parallel.multihost import partition_scenes
from s_volsdf_tpu_torch.parallel.train_parallel import (
    make_sharded_multiscene_train_fn, make_sharded_scene_ray_train_fn,
    scene_block)
from s_volsdf_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("s_volsdf_tpu_torch")


def _pack_stacked(cfg: Config, trainers: List[VolTrainer]) -> SceneVolumes:
    """The S trainers' volumes for the lockstep loop: each stored in
    `train.mvs_pack_dtype` (kept as the trainer's `mvs`), and their
    stacked kernel copy written one scene at a time, which bounds the
    transient to one scene's corner-block copy (the JAX package packs
    one scene at a time for the same reason)."""
    stored, volumes = pack_for_chunk_scenes(cfg, [t.mvs for t in trainers])
    for t, m in zip(trainers, stored):
        t.mvs = m
    return volumes


@dataclasses.dataclass(frozen=True)
class Layout:
    """How S scenes run on the node's ranks: "scene" (contiguous blocks
    of scenes over a `shape` = (n,) mesh, make_sharded_multiscene_
    train_fn), "scene_rays" (a (S, rays) mesh,
    make_sharded_scene_ray_train_fn) or "lockstep" (every rank runs
    every scene, make_multiscene_train_fn)."""
    kind: str
    shape: Tuple[int, ...] = (1,)

    @property
    def axes(self) -> Tuple[str, ...]:
        return ("scene", "rays")[:len(self.shape)]


def _pick_loop(cfg: Config, S: int, n_ranks: int) -> Layout:
    """The widest layout of S scenes that n ranks admit, as the JAX
    package's `_pick_loop` picks over its devices: the scenes over all
    ranks when n divides S; a 2-D (scene x rays) mesh when there are
    spare ranks a scene (S < n), parallel.shard_rays is set and the
    scene's num_pixels divide over them; one scene a rank on S ranks
    when 1 < S < n otherwise; else the lockstep loop on every rank.

    parallel.shard_rays=false keeps each scene's rays on one rank, so
    that its trajectory stays the one-process lockstep run's."""
    n = n_ranks
    if n > 1 and S % n == 0:
        logger.info(f"multiscene: {S} scenes sharded over {n} devices")
        return Layout("scene", (n,))
    ray_chips = n // S if S < n else 0
    if (cfg.parallel.shard_rays and ray_chips > 1
            and cfg.train.num_pixels % ray_chips == 0):
        logger.info(
            f"multiscene: 2D mesh — {S} scenes x {ray_chips} ray-chips "
            f"each ({cfg.train.num_pixels // ray_chips} rays/chip, "
            f"{S * ray_chips}/{n} devices)")
        return Layout("scene_rays", (S, ray_chips))
    if 1 < S < n:
        logger.info(f"multiscene: {S} scenes sharded over {S}/{n} devices")
        return Layout("scene", (S,))
    logger.info(f"multiscene: {S} scenes vmapped on one device"
                + (f" ({n} devices visible but {S} not divisible)"
                   if n > 1 else ""))
    return Layout("lockstep")


def _loop(cfg: Config, layout: Layout, mesh: Optional[RankMesh], tx, *,
          use_mvs: bool, n_views: int, img_res):
    """The training loop of this rank's scenes under `layout`."""
    kw = dict(use_mvs=use_mvs, n_views=n_views, img_res=img_res)
    if layout.kind == "scene_rays":
        return make_sharded_scene_ray_train_fn(cfg, tx, mesh, **kw)
    if layout.kind == "scene":
        return make_sharded_multiscene_train_fn(cfg, tx, mesh, **kw)
    return make_multiscene_train_fn(cfg, tx, **kw)


def _scene_losses(lo: LossOutput) -> List[LossOutput]:
    """Each scene's LossOutput of a lockstep step, as host floats (one
    copy to the host for all the fields)."""
    fields = list(lo[:-1])
    present = [i for i, x in enumerate(fields) if x is not None]
    values = torch.stack([fields[i] for i in present]).tolist()
    out = []
    for s, finite in enumerate(lo.grad_finite):
        row = [None] * len(fields)
        for i, v in zip(present, values):
            row[i] = v[s]
        out.append(LossOutput(*row, grad_finite=finite))
    return out


def run_joint(trainers: List[VolTrainer], opt_stepN: int,
              chunk_steps: int = 200, log_every: int = 1000) -> None:
    """Advance every trainer by opt_stepN steps in lockstep (the joint
    counterpart of VolTrainer.run). Each trainer's parameters, Adam
    state, iter_step, generator and epoch are updated in place, its
    per-step losses and seconds recorded (`losses`, `step_seconds`,
    `chunk_seconds`, `last_guard_trips`), and, with a run directory, its
    "latest" and "epoch_<n>" checkpoints written at the end. Under a
    process group the scenes are spread over the node's ranks
    (`_pick_loop`; module docstring) and every trainer ends alike on
    every rank."""
    cfg = trainers[0].cfg
    S = len(trainers)
    device = trainers[0].device
    n_views = len(trainers[0].trains_i)
    img_res = trainers[0].scene.img_res
    for t in trainers:
        if (t.device != device or len(t.trains_i) != n_views
                or tuple(t.scene.img_res) != tuple(img_res)):
            raise ValueError(
                f"run_joint: scene {t.scan} ({t.device}, {len(t.trains_i)} "
                f"views of {t.scene.img_res}) does not match scene "
                f"{trainers[0].scan} ({device}, {n_views} views of "
                f"{img_res}): lockstep training takes scenes of one shape")
    group = node_group()
    layout = _pick_loop(cfg, S, group.size if group is not None else 1)
    mesh = None if layout.kind == "lockstep" else make_group(layout.shape,
                                                             layout.axes)
    mine = list(range(S)) if mesh is None else scene_block(mesh, S)
    for t in trainers:
        t.losses, t.step_seconds, t.chunk_seconds = [], [], []
        t.last_guard_trips = 0
    if mine:
        _train_scenes([trainers[s] for s in mine], opt_stepN, layout, mesh,
                      chunk_steps, log_every)
    if mesh is not None:   # each scene from the first rank that trained it
        firsts = mesh.ranks.reshape(mesh.shape["scene"], -1)[:, 0]
        per = S // len(firsts)
        for s, t in enumerate(trainers):
            share_trainer(group, t, group.ranks.index(int(firsts[s // per])))
    for t in trainers:
        t.epoch += max(1, opt_stepN // max(n_views, 1))
        t._snapshot()
        t._snapshot(f"epoch_{t.epoch}")


def _train_scenes(trainers: List[VolTrainer], opt_stepN: int, layout: Layout,
                  mesh: Optional[RankMesh], chunk_steps: int,
                  log_every: int) -> None:
    """This rank's scenes of `run_joint`, in lockstep under `layout`."""
    cfg = trainers[0].cfg
    S = len(trainers)
    n_views = len(trainers[0].trains_i)
    use_mvs = bool(cfg.use_mvs) and all(t.mvs is not None for t in trainers)
    mvs = _pack_stacked(cfg, trainers) if use_mvs else None
    state = stack_states([t.state for t in trainers])
    run = _loop(cfg, layout, mesh, state.opt_state, use_mvs=use_mvs,
                n_views=n_views, img_res=trainers[0].scene.img_res)
    scenes = [t.scene_tensors() for t in trainers]
    gens = [t.gen for t in trainers]

    start = state.iter_step
    done = 0
    next_log = log_every
    logger.info(f"joint volsdf: {S} scenes, start={start} steps={opt_stepN} "
                f"use_mvs={use_mvs}")
    while done < opt_stepN:
        n = min(chunk_steps, opt_stepN - done)
        t0 = time.perf_counter()
        state, losses, seconds = run(state, n, scenes, mvs, gens)
        chunk_s = time.perf_counter() - t0
        per_step = [_scene_losses(lo) for lo in losses]
        for s, t in enumerate(trainers):
            mine = [step[s] for step in per_step]
            t.losses += mine
            t.step_seconds += seconds
            t.chunk_seconds.append(chunk_s)
            t.last_guard_trips += sum(lo.grad_finite == 0.0 for lo in mine)
        done += n
        if done >= next_log or done >= opt_stepN:
            last = [t.losses[-1] for t in trainers]
            logger.info(f"joint step {start + done}: loss="
                        + ",".join(f"{lo.loss:.4f}" for lo in last)
                        + " psnr=" + ",".join(f"{lo.psnr:.1f}" for lo in last))
            next_log += log_every
    for s, t in enumerate(trainers):
        t.take_scene(state, s)


def share_trainer(group: Group, trainer: VolTrainer, src: int) -> None:
    """The trainer of the rank at place `src` of `group`, on every rank:
    its parameters and Adam state (moments and counts) in place, its
    iter_step, generator state and last run's records."""
    params = list(trainer.state.params.parameters())
    adam = trainer.tx.adam
    meta = group.broadcast_object(
        {"iter_step": trainer.state.iter_step,
         "gen": trainer.gen.get_state(),
         "counts": [float(adam.state[p]["step"]) if adam.state.get(p)
                    else None for p in params],
         "records": (trainer.losses, trainer.step_seconds,
                     trainer.chunk_seconds, trainer.last_guard_trips)},
        src)
    if group.index != src:
        for p, count in zip(params, meta["counts"]):
            adam.state.pop(p, None)
            if count is not None:
                adam.state[p] = {
                    "step": torch.tensor(count, dtype=torch.float32),
                    "exp_avg": torch.zeros_like(p),
                    "exp_avg_sq": torch.zeros_like(p)}
        trainer.state.iter_step = meta["iter_step"]
        trainer.gen.set_state(meta["gen"])
        (trainer.losses, trainer.step_seconds, trainer.chunk_seconds,
         trainer.last_guard_trips) = meta["records"]
    moments = [adam.state[p][k] for p in params if adam.state.get(p)
               for k in ("exp_avg", "exp_avg_sq")]
    with torch.no_grad():
        group.broadcast(params + moments, src)


def override_groups(cfg: Config, testlist: List[str]) -> List[tuple]:
    """The scenes of `testlist` grouped by their per-scan override config
    (`per_scene_overrides`), in the order each group first appears:
    [(group config, [scans])]. A group's scenes share every setting of
    the step."""
    groups: Dict[str, tuple] = {}
    for scene in testlist:
        gcfg = per_scene_overrides(cfg, scene)
        groups.setdefault(repr(gcfg), (gcfg, []))[1].append(scene)
    return list(groups.values())


def save_depth_multiscene(cfg: Config, testlist: List[str], *,
                          mvs_weights: Optional[str] = None,
                          exps_root: str = ".", device=None
                          ) -> Dict[str, Dict]:
    """The multi-scene counterpart of `engine.runner.save_depth`, on the
    scenes this node owns (`partition_scenes`): per override group, the
    cascade per scene, the VolSDF optimisations of a stage jointly
    (`run_joint`), the feedback renders and the outputs per scene. Runs
    on `device` ("cuda" by default; without a CUDA device this raises
    rather than run on the CPU, which takes device="cpu"). Returns each
    scan's trainer and output directory."""
    from s_volsdf_tpu_torch.engine.runner import (MVSEngine,
                                                  accumulate_stage,
                                                  feedback_depths,
                                                  run_mvs_stage,
                                                  save_scene_outputs,
                                                  setup_scene)
    dev = resolve_device(device, "save_depth_multiscene")
    groups = override_groups(cfg, partition_scenes(testlist))
    if len(groups) > 1:
        logger.info(f"multiscene: {len(groups)} override groups "
                    f"{[len(scans) for _, scans in groups]}")
    results: Dict[str, Dict] = {}
    # One engine for every group: the overrides never touch cfg.mvs.
    engine = MVSEngine(cfg, weights_path=mvs_weights, device=dev)
    for gcfg, scans in groups:
        scs = [setup_scene(gcfg, s, exps_root=exps_root, device=dev)
               for s in scans]
        for stage_idx in range(3):
            stage_outs = [run_mvs_stage(gcfg, engine, sc, stage_idx)
                          for sc in scs]
            do_volopt = (not gcfg.ablate
                         and gcfg.opt_stepNs[stage_idx] > 0
                         and gcfg.use_nerf_d[stage_idx] > 0)
            if do_volopt:
                for sc, (outs, _) in zip(scs, stage_outs):
                    sc["trainer"].stg = stage_idx
                    sc["trainer"].get_mvs_input(outs)
                # > 1, as save_scene_depth: a budget of 1 renders the
                # feedback depth without a step.
                if gcfg.opt_stepNs[stage_idx] > 1:
                    run_joint([sc["trainer"] for sc in scs],
                              gcfg.opt_stepNs[stage_idx])
                for sc, (outs, _) in zip(scs, stage_outs):
                    feedback_depths(sc, outs)
            for sc, (outs, extras) in zip(scs, stage_outs):
                accumulate_stage(sc, outs, extras, stage_idx)
        for scan, sc in zip(scans, scs):
            if is_writer():
                save_scene_outputs(sc)
            logger.info(f"scene {scan}: outputs saved to {sc['outdir']}")
            results[scan] = {"trainer": sc["trainer"],
                             "outdir": sc["outdir"]}
    return results
