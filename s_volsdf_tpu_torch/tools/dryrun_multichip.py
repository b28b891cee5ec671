"""Dry run of the port's multi-device paths on n gloo ranks at tiny shapes
(counterpart of the JAX package's `dryrun_multichip`):

    python -m s_volsdf_tpu_torch.tools.dryrun_multichip --n 2

Spawns n ranks on this machine (parallel.mesh.run_local_ranks; the CPU
by default, or "cuda:<k>" for ranks sharing one card) that run:

  1. make_sharded_train_step: one step on each rank's rows of a drawn
     batch, with MVS volumes (gradients averaged over the ranks);
  2. make_sharded_scan_train_fn: the trainer's ray-sharded loop, 2
     chunks of 4 steps;
  3. make_sharded_multiscene_train_fn: n scenes, one a rank, 3 steps;
  4. render_depth over the eval group (each chunk's rays split);
  5. make_sharded_scene_ray_train_fn: 2 scenes x n/2 ranks each (n even
     and at least 4), 3 steps.

Every loss must be finite and every rank's parameters equal to the
first rank's; it prints one line a path and exits non-zero otherwise.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, List

import numpy as np
import torch

from s_volsdf_tpu_torch.config import load_config
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
from s_volsdf_tpu_torch.engine.render import render_depth
from s_volsdf_tpu_torch.engine.train_step import (draw_step_inputs,
                                                  init_train_state,
                                                  make_optimizer)
from s_volsdf_tpu_torch.engine.trainer import stack_states
from s_volsdf_tpu_torch.models.network import init_volsdf_params
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes
from s_volsdf_tpu_torch.parallel import mesh as pmesh
from s_volsdf_tpu_torch.parallel.train_parallel import (
    make_sharded_multiscene_train_fn, make_sharded_scan_train_fn,
    make_sharded_scene_ray_train_fn, make_sharded_train_step, scene_block)

IMG_RES = (32, 48)


def tiny_config():
    """The dtu preset at the dry run's size, in float32."""
    return load_config("dtu", overrides=[
        "train.num_pixels=64", "model.implicit.dims=[64,64,64,64]",
        "model.implicit.skip_in=[]", "model.rendering.dims=[64,64]",
        "model.feature_vector_size=64", "model.sampler.N_samples=16",
        "model.sampler.N_samples_eval=32", "model.sampler.N_samples_extra=8",
        "train.train_compute_dtype=float32",
        "train.train_activation_dtype=float32",
        "train.mvs_pack_dtype=float32"])


def _state(cfg, seed: int, device):
    params = init_volsdf_params(torch.Generator().manual_seed(seed),
                                cfg.model, device)
    return init_train_state(cfg, params, make_optimizer(cfg, params))


def _scene(device) -> Dict[str, torch.Tensor]:
    scene = make_sphere_scene(3, IMG_RES)
    imgs = torch.as_tensor(scene.images.reshape(3, -1, 3), device=device)
    return {"rgb": imgs, "rgb_smooth": imgs,
            "poses": torch.as_tensor(scene.poses, device=device),
            "intrinsics": torch.as_tensor(scene.intrinsics, device=device)}


def _volumes(scene: Dict, device) -> MVSVolumes:
    D, Hc, Wc = 16, 16, 24
    prob = torch.rand((3, D, Hc, Wc), generator=torch.Generator()
                      .manual_seed(1)).to(device)
    prob = prob / prob.sum(dim=1, keepdim=True)
    z_slab = torch.stack([torch.full((3, Hc, Wc), 0.5),
                          torch.full((3, Hc, Wc), 5.0)], dim=1).to(device)
    return MVSVolumes(prob=prob, z_slab=z_slab,
                      intrinsics=scene["intrinsics"], c2w=scene["poses"],
                      img_res=IMG_RES, inverse_depth=False)


def _finite(what: str, losses: List[float]) -> None:
    if not (losses and np.all(np.isfinite(losses))):
        raise RuntimeError(f"{what}: losses {losses}")


def _params_equal(group, state, what: str) -> None:
    """Every rank's parameters equal to the group's first rank's."""
    mine = [p.detach().clone() for p in state.params.parameters()]
    first = [p.clone() for p in mine]
    group.broadcast(first, 0)
    if not all(torch.equal(a, b) for a, b in zip(mine, first)):
        raise RuntimeError(f"{what}: the replicas' parameters differ")


def run_paths() -> Dict[str, object]:
    """The five paths on this rank; returns a line a path."""
    cfg = tiny_config()
    device = pmesh.rank_device()
    group = pmesh.node_group()
    n = group.size
    scene = _scene(device)
    mvs = _volumes(scene, device)
    out = {}

    # 1. One sharded step on this rank's rows of a drawn batch.
    state = _state(cfg, 0, device)
    gen = torch.Generator(device=device).manual_seed(2)
    batch = draw_step_inputs(scene, gen, cfg=cfg, n_views=3, img_res=IMG_RES,
                             n_rays=cfg.train.num_pixels // n, group=group)
    step = make_sharded_train_step(cfg, state.opt_state, group, use_mvs=True)
    state, lo = step(state, batch, None, mvs)
    _finite("sharded step", [float(lo.loss)])
    _params_equal(group, state, "sharded step")
    out["step"] = float(lo.loss)

    # 2. The trainer's ray-sharded loop, 2 chunks of 4 steps.
    state = _state(cfg, 0, device)
    run = make_sharded_scan_train_fn(cfg, state.opt_state, group,
                                     use_mvs=True, n_views=3, img_res=IMG_RES)
    gen = torch.Generator(device=device).manual_seed(10)
    losses = []
    for _ in range(2):
        state, los, _ = run(state, 4, scene, mvs, gen)
        losses += [float(x.loss) for x in los]
    _finite("sharded loop", losses)
    if state.iter_step != 8:
        raise RuntimeError(f"sharded loop: iter_step {state.iter_step}")
    _params_equal(group, state, "sharded loop")
    out["loop"] = losses

    # 3. n scenes, one a rank, no collective.
    smesh = pmesh.make_group((n,), ("scene",))
    mine = scene_block(smesh, n)
    states = stack_states([_state(cfg, s, device) for s in mine])
    fn = make_sharded_multiscene_train_fn(cfg, states.opt_state, smesh,
                                          use_mvs=False, n_views=3,
                                          img_res=IMG_RES)
    gens = [torch.Generator(device=device).manual_seed(20 + s) for s in mine]
    states, los, _ = fn(states, 3, [scene] * len(mine), None, gens)
    _finite("scene-sharded loop", [float(v) for x in los for v in x.loss])
    out["scenes"] = mine

    # 4. A depth render over the eval group.
    egroup = pmesh.eval_group(cfg.parallel, n * 32)
    maps = render_depth(state.params, cfg.model, scene["poses"][0].cpu(),
                        scene["intrinsics"][0].cpu(), IMG_RES, chunk=n * 32,
                        fast=1, device=device, group=egroup)
    if not np.all(np.isfinite(maps["depth"])):
        raise RuntimeError("sharded render: non-finite depth")
    out["render"] = float(np.mean(maps["depth"]))

    # 5. 2 scenes x n/2 ranks each.
    if n >= 4 and n % 2 == 0:
        m2 = pmesh.make_group((2, n // 2), ("scene", "rays"))
        mine = scene_block(m2, 2)
        states = stack_states([_state(cfg, s, device) for s in mine])
        fn = make_sharded_scene_ray_train_fn(cfg, states.opt_state, m2,
                                             use_mvs=False, n_views=3,
                                             img_res=IMG_RES)
        gens = [torch.Generator(device=device).manual_seed(30 + s)
                for s in mine]
        states, los, _ = fn(states, 3, [scene] * len(mine), None, gens)
        _finite("scene x rays loop", [float(v) for x in los for v in x.loss])
        _params_equal(m2.group("rays"), states, "scene x rays loop")
        out["scene_rays"] = mine
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n", type=int, default=2, help="ranks")
    p.add_argument("--device", default="cpu",
                   help='"cpu", or "cuda:<k>" for ranks sharing one card')
    p.add_argument("--timeout", type=float, default=600.0)
    opt = p.parse_args(argv)
    results = pmesh.run_local_ranks(run_paths, opt.n, device=opt.device,
                                    backend="gloo", timeout=opt.timeout)
    for rank, res in enumerate(results):
        print(f"rank {rank}: {res}")
    print(f"dryrun_multichip ok on {opt.n} ranks ({opt.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
