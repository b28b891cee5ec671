"""Multi-device VolSDF training (counterpart of
s_volsdf_tpu/parallel/train_parallel.py): one scene's rays sharded over
a group of ranks with one gradient all_reduce a step, scenes sharded
over ranks with no collective, and the two composed.

* `make_sharded_scan_train_fn`: the trainer's multi-rank loop. One
  scene's step of cfg.train.num_pixels rays splits over the group: every
  rank draws the whole step alike (the same view, pixels and noise as
  one process) and renders its own rows; the gradients and the loss
  statistics are averaged over the group (one all_reduce each) and
  every rank applies the same update, so the replicas stay equal.
* `make_sharded_train_step`: one step on this rank's rows of a given
  batch (and of its jitter feed), for tests and the smoke run.
* `make_sharded_multiscene_train_fn`: S scenes over the ranks of a
  mesh's scene axis, each rank running the lockstep loop on its own
  contiguous block of them (`scene_block`), with no collective.
* `make_sharded_scene_ray_train_fn`: the 2-D composition: the scenes
  over the scene axis, each block's rays over its ray axis.

The loops take and return what the single-process loops of
engine/trainer.py do, on this rank's scenes. The parameters, the Adam
state and the generators are broadcast from the ray group's first rank
when a loop first runs; after that every rank applies the same averaged
update.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from s_volsdf_tpu_torch.config import Config
from s_volsdf_tpu_torch.engine.train_step import (StackedOptimizer,
                                                  TrainState, guarded_update,
                                                  loss_and_grads,
                                                  mean_over_group)
from s_volsdf_tpu_torch.models.loss import LossOutput
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes
from s_volsdf_tpu_torch.parallel.mesh import Group, RankMesh


def _check_rays(cfg: Config, n: int, axis: str) -> int:
    n_rays = cfg.train.num_pixels
    if n_rays % n != 0:
        raise ValueError(f"train.num_pixels={n_rays} not divisible by mesh "
                         f"axis {axis!r} size {n}")
    return n_rays // n


def _state_tensors(state: TrainState) -> List[torch.Tensor]:
    """The parameters and the Adam moments of a state (serial or
    stacked), in a fixed order."""
    params = list(state.params.parameters())
    tx = state.opt_state
    if isinstance(tx, StackedOptimizer):
        return params + tx.exp_avg + tx.exp_avg_sq
    moments = [st[k] for st in (tx.adam.state.get(p, {}) for p in params)
               if st for k in ("exp_avg", "exp_avg_sq")]
    return params + moments


def replicate(group: Group, state: TrainState,
              gens: List[torch.Generator]) -> None:
    """The state (parameters, Adam moments) and the generators' states of
    the group's first rank, in place on every rank (the JAX package's
    replicated P() inputs)."""
    with torch.no_grad():
        group.broadcast(_state_tensors(state), 0)
    states = group.broadcast_object([g.get_state() for g in gens], 0)
    for g, st in zip(gens, states):
        g.set_state(st)


def _replicating(run_chunk, group: Group, gens_of):
    """run_chunk, which replicates its inputs over `group` on its first
    call."""
    done = []

    def run(state, n_steps, scene, mvs, gen):
        if not done:
            replicate(group, state, gens_of(gen))
            done.append(True)
        return run_chunk(state, n_steps, scene, mvs, gen)

    run.group = group
    return run


def make_sharded_scan_train_fn(cfg: Config, tx, group: Group, *,
                               use_mvs: bool, n_views: int,
                               img_res: Tuple[int, int], axis: str = "rays"):
    """The ray-sharded training loop over `group` (see the module
    docstring), in place of engine.trainer.make_scan_train_fn, with its
    (state, n_steps, scene, mvs, gen) signature. cfg.train.num_pixels is
    the step's whole ray count and must divide by the group's size."""
    from s_volsdf_tpu_torch.engine.trainer import make_scan_train_fn
    n_local = _check_rays(cfg, group.size, axis)
    run_chunk = make_scan_train_fn(cfg, tx, use_mvs=use_mvs, n_views=n_views,
                                   img_res=img_res, n_rays=n_local,
                                   group=group)
    return _replicating(run_chunk, group, lambda gen: [gen])


def make_sharded_train_step(cfg: Config, tx, group: Group, *, use_mvs: bool):
    """One step over `group` on a given batch: each rank passes its rows
    of the batch's rays and of its jitter feed
    (engine.train_step.shard_batch); the gradients and the loss
    statistics are averaged over the group before the guard. Signature
    of engine.train_step.train_step: (state, batch, gen, mvs)."""

    def step(state: TrainState, batch: Dict, gen,
             mvs: Optional[MVSVolumes]) -> Tuple[TrainState, LossOutput]:
        grads, loss_out = mean_over_group(group, *loss_and_grads(
            state.params, cfg, batch, gen, mvs if use_mvs else None,
            state.iter_step))
        return guarded_update(tx, state, grads, loss_out)

    return step


def scene_block(mesh: RankMesh, S: int, axis: str = "scene") -> List[int]:
    """The scenes of S that this rank's coordinate on `axis` owns: its
    contiguous block of S / size (the JAX package's P(axis)); none for a
    rank outside the mesh."""
    n = mesh.shape[axis]
    if S % n != 0:
        raise ValueError(f"{S} scenes not divisible by mesh axis {axis!r} "
                         f"size {n}")
    if mesh.coords is None:
        return []
    k = S // n
    c = mesh.coords[mesh.axis_names.index(axis)]
    return list(range(c * k, (c + 1) * k))


def make_sharded_multiscene_train_fn(cfg: Config, tx: StackedOptimizer,
                                     mesh: RankMesh, *, use_mvs: bool,
                                     n_views: int, img_res: Tuple[int, int],
                                     axis: str = "scene"):
    """The lockstep loop of this rank's scenes (`scene_block` of `mesh`'s
    `axis`; `tx` and the loop's inputs are theirs), with no collective:
    each scene's trajectory is the one-process lockstep run's."""
    from s_volsdf_tpu_torch.engine.trainer import make_multiscene_train_fn
    del mesh, axis        # the caller picks the block; nothing is shared
    return make_multiscene_train_fn(cfg, tx, use_mvs=use_mvs,
                                    n_views=n_views, img_res=img_res)


def make_sharded_scene_ray_train_fn(cfg: Config, tx: StackedOptimizer,
                                    mesh: RankMesh, *, use_mvs: bool,
                                    n_views: int, img_res: Tuple[int, int],
                                    scene_axis: str = "scene",
                                    ray_axis: str = "rays"):
    """The 2-D loop: this rank's scenes (`scene_block` on `scene_axis`)
    in lockstep, each scene's cfg.train.num_pixels rays sharded over the
    ranks of its `ray_axis` line, whose all_reduces carry the gradient
    means; the scene axis carries nothing. Each scene's trajectory is
    `make_sharded_scan_train_fn`'s on a group of the same size."""
    from s_volsdf_tpu_torch.engine.trainer import make_multiscene_train_fn
    n_local = _check_rays(cfg, mesh.shape[ray_axis], ray_axis)
    group = mesh.group(ray_axis)
    run_chunk = make_multiscene_train_fn(cfg, tx, use_mvs=use_mvs,
                                         n_views=n_views, img_res=img_res,
                                         n_rays=n_local, group=group)
    return _replicating(run_chunk, group, list)
