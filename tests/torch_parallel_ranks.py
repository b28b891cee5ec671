"""What the ranks of tests/test_torch_parallel*.py run, each in a process
of a gloo group on the CPU (`parallel.mesh.run_local_ranks`). This module
imports no JAX: the tests compute the JAX side in their own process and
pass numpy arrays both ways. Every function takes one `spec` dict and
returns a dict of numpy arrays and numbers.
"""

import dataclasses
import logging
import os

import numpy as np
import torch

from s_volsdf_tpu_torch.bridge import from_jax_params
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
from s_volsdf_tpu_torch.engine import multiscene
from s_volsdf_tpu_torch.engine import train_step as tts
from s_volsdf_tpu_torch.engine.mesh import eval_sdf_grid, mesh_sdf_fn
from s_volsdf_tpu_torch.engine.render import render_depth, render_image
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes
from s_volsdf_tpu_torch.parallel import mesh as pmesh
from s_volsdf_tpu_torch.parallel.train_parallel import (
    make_sharded_scan_train_fn, make_sharded_train_step)


def params_np(params):
    return [p.detach().numpy().copy() for p in params.parameters()]


def adam_np(opt):
    return [{k: (v.numpy().copy() if torch.is_tensor(v) else v)
             for k, v in opt.adam.state[p].items()}
            for p in opt.params if opt.adam.state.get(p)]


def batch_of(arrays):
    """A port batch from numpy arrays (a jitter feed under "jitter")."""
    out = {k: torch.tensor(v) for k, v in arrays.items() if k != "jitter"}
    if "jitter" in arrays:
        out["jitter"] = {k: torch.tensor(v)
                         for k, v in arrays["jitter"].items()}
    return out


def volumes(spec):
    prob, z_slab, intr, poses, img_res = spec["mvs"]
    return MVSVolumes(prob=torch.tensor(prob), z_slab=torch.tensor(z_slab),
                      intrinsics=torch.tensor(intr), c2w=torch.tensor(poses),
                      img_res=img_res, inverse_depth=False)


def fresh_state(cfg, spec):
    params = from_jax_params(spec["params"])
    return tts.init_train_state(cfg, params, tts.make_optimizer(cfg, params))


def trainer(cfg, spec, **kw):
    """A VolTrainer of the sphere scene with the spec's volumes."""
    scene = scene_from_synthetic(make_sphere_scene(3, spec["img_res"]))
    t = VolTrainer(cfg, scene, "scan106", device="cpu", chunk_steps=2, **kw)
    t.mvs = volumes(spec)
    return t


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _step_checks(spec, group, out):
    """One sharded step against the whole batch, three steps for the
    replicas, the NaN guard."""
    cfg, mvs = spec["cfg"], volumes(spec)
    batch = tts.shard_batch(batch_of(spec["batches"][0]), group)
    state = fresh_state(cfg, spec)
    state.iter_step = spec["iter_step"]
    grads, lo = tts.mean_over_group(group, *tts.loss_and_grads(
        state.params, cfg, batch, None, mvs, state.iter_step))
    out["grads"] = [g.numpy() for g in grads]
    out["loss"] = float(lo.loss)
    step = make_sharded_train_step(cfg, state.opt_state, group, use_mvs=True)
    state, lo = step(state, batch, None, mvs)
    out["step_loss"] = float(lo.loss)
    out["step_finite"] = lo.grad_finite
    for arrays in spec["batches"][1:3]:
        state, lo = step(state, tts.shard_batch(batch_of(arrays), group),
                         None, mvs)
    out["replica"] = params_np(state.params)

    # The NaN guard, past the RGB anneal: NaN in the last rank's rows.
    state = fresh_state(cfg, spec)
    state.iter_step = cfg.loss.anneal_rgb + 10
    step = make_sharded_train_step(cfg, state.opt_state, group, use_mvs=True)
    state, lo = step(state, tts.shard_batch(batch_of(spec["batches"][0]),
                                            group), None, mvs)
    before = params_np(state.params), adam_np(state.opt_state)
    bad = tts.shard_batch(batch_of(spec["batches"][1]), group)
    if group.index == group.size - 1:
        bad["rgb"] = bad["rgb"] * float("nan")
    state, lo = step(state, bad, None, mvs)
    out["nan_finite"] = lo.grad_finite
    out["nan_params_kept"] = all(
        np.array_equal(a, b, equal_nan=True)
        for a, b in zip(before[0], params_np(state.params)))
    out["nan_adam_kept"] = all(
        all(np.array_equal(x[k], y[k]) for k in x)
        for x, y in zip(before[1], adam_np(state.opt_state)))
    out["nan_iter_step"] = state.iter_step


def _loop_checks(spec, group, out):
    """The loop's draws, a rerun, a resume, the checkpoints both ways,
    an indivisible ray count."""
    cfg = spec["cfg"]
    scene = trainer(cfg, spec).scene_tensors()
    gen = torch.Generator().manual_seed(3)
    b = tts.draw_step_inputs(scene, gen, cfg=cfg, n_views=3,
                             img_res=spec["img_res"],
                             n_rays=cfg.train.num_pixels // group.size,
                             group=group)
    out["draw_view"] = b["view_onehot"].numpy()
    out["draw_uv"] = b["uv"].numpy()
    out["draw_t_rand"] = b["jitter"]["t_rand"].numpy()

    root = spec["tmp"]
    whole = trainer(cfg, spec, exps_root=os.path.join(root, "whole"))
    out["loop_group"] = whole._get_loop(True).group is not None
    whole.run(6)
    out["whole"] = params_np(whole.state.params)
    out["whole_losses"] = [lo.loss for lo in whole.losses]
    again = trainer(cfg, spec)
    again.run(6)
    out["again"] = params_np(again.state.params)
    cut = trainer(cfg, spec, exps_root=os.path.join(root, "cut"))
    cut.run(3)
    resumed = trainer(cfg, spec, exps_root=os.path.join(root, "cut"),
                      is_continue=True)
    resumed.run(3)
    out["resumed"] = params_np(resumed.state.params)
    # A one-process run's checkpoint (written before the ranks started).
    solo = trainer(cfg, spec, exps_root=os.path.join(root, "solo"),
                   is_continue=True)
    out["solo_step"] = solo.state.iter_step
    out["solo_params"] = params_np(solo.state.params)

    bad = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, num_pixels=cfg.train.num_pixels + 1))
    try:
        make_sharded_scan_train_fn(bad, whole.tx, group, use_mvs=False,
                                   n_views=3, img_res=spec["img_res"])
        out["indivisible_raises"] = False
    except ValueError as e:
        out["indivisible_raises"] = "not divisible" in str(e)
    records = _Records()
    logging.getLogger("s_volsdf_tpu_torch").addHandler(records)
    try:
        out["indivisible_group"] = trainer(bad, spec)._get_loop(True).group
    finally:
        logging.getLogger("s_volsdf_tpu_torch").removeHandler(records)
    out["indivisible_log"] = records.lines


def _scene_checks(spec, out):
    """4 scenes over the ranks through run_joint."""
    trainers = [trainer(dataclasses.replace(spec["cfg"], seed=s), spec)
                for s in range(4)]
    multiscene.run_joint(trainers, 4, chunk_steps=2)
    out["scenes"] = [params_np(t.state.params) for t in trainers]
    out["scene_losses"] = [[lo.loss for lo in t.losses] for t in trainers]
    out["scene_adam"] = [adam_np(t.tx) for t in trainers]
    out["scene_gen"] = [t.gen.get_state().numpy() for t in trainers]


def _render_checks(spec, out):
    """Renders and an SDF grid over the eval group, and its gates."""
    cfg = spec["cfg"]
    params = from_jax_params(spec["params"])
    group = pmesh.eval_group(cfg.parallel, spec["chunk"])
    pose, intr, res = spec["view"]
    out["image"] = render_image(params, cfg.model, pose, intr, res,
                                chunk=spec["chunk"], fast=spec["fast"],
                                group=group)
    out["depth"] = render_depth(params, cfg.model, pose, intr, res,
                                chunk=spec["chunk"], fast=spec["fast"],
                                group=group)
    sdf_fn = mesh_sdf_fn(params, cfg.model, cfg.model.scene_bounding_sphere)
    out["grid"] = eval_sdf_grid(sdf_fn, spec["grid"], chunk=spec["chunk"],
                                group=group)
    p = cfg.parallel
    gates = {"on": (p, 16384), "indivisible": (p, 13),
             "off": (dataclasses.replace(p, shard_eval=False), 16384),
             "one_rank": (dataclasses.replace(p, mesh_shape=(1,)), 16384)}
    out["gates"] = {k: None if pmesh.eval_group(*a) is None
                    else pmesh.eval_group(*a).ranks for k, a in gates.items()}


def two_rank_checks(spec):
    """Every check of tests/test_torch_parallel.py that runs at 2 ranks."""
    group = pmesh.node_group()
    out = {"rank": group.index}
    _step_checks(spec, group, out)
    _loop_checks(spec, group, out)
    _scene_checks(spec, out)
    _render_checks(spec, out)
    return out


def four_rank_checks(spec):
    """2 scenes over 4 ranks (a 2 x 2 scene x rays mesh) through
    run_joint, and each scene's 2-rank ray-sharded loop on its pair."""
    out = {}
    trainers = [trainer(dataclasses.replace(spec["cfg"], seed=s), spec)
                for s in range(2)]
    multiscene.run_joint(trainers, 4, chunk_steps=2)
    out["joint"] = [params_np(t.state.params) for t in trainers]
    out["joint_losses"] = [[lo.loss for lo in t.losses] for t in trainers]
    me = pmesh.topology().rank
    pair = pmesh.make_group((2, 2), ("scene", "rays")).group("rays")
    s = me // 2
    t = trainer(dataclasses.replace(spec["cfg"], seed=s), spec)
    t.mvs = tts.pack_for_chunk(t.cfg, t.mvs)
    run = make_sharded_scan_train_fn(t.cfg, t.tx, pair, use_mvs=True,
                                     n_views=3, img_res=spec["img_res"])
    t.state, losses, _ = run(t.state, 4, t.scene_tensors(), t.mvs, t.gen)
    out["pair"] = params_np(t.state.params)
    out["pair_losses"] = [float(lo.loss) for lo in losses]
    out["scene"] = s
    return out


# --------------------------------------------------------------------------
# tests/test_torch_parallel_pipeline.py
# --------------------------------------------------------------------------

def cascade_sc(cfg, data_root):
    """The per-scene pieces run_mvs_stage reads: scan106's MVS samples."""
    from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset
    from s_volsdf_tpu_torch.data.splits import get_trains_ids
    trains_i = get_trains_ids("DTU", "scan106", cfg.num_view)
    ds = MVSDataset(
        datapath=os.path.join(data_root, "DTU", "mvs_data"), scan="scan106",
        nviews=cfg.num_view, data_dir="DTU", ndepths=cfg.mvs.numdepth,
        interval_scale=cfg.mvs.interval_scale, max_h=cfg.max_h,
        max_w=cfg.max_w, trains_i=trains_i, data_dir_root=data_root,
        x2_mvsres=cfg.mvs.x2_mvsres)
    samples = [ds[i] for i in range(len(ds))]
    return {"name": "scan106", "samples": samples, "trains_i": trains_i,
            "outs_samples": [None] * len(samples),
            "extras": [None] * len(samples), "stage_seconds": [],
            "stage_peak_bytes": []}


def cascade_stages(cfg, ck, data_root):
    """Three stages of each view of scan106 (run_mvs_stage): per stage,
    each view's depth, confidence, probability volume and hypotheses and
    its extra, as numpy."""
    from s_volsdf_tpu_torch.engine.runner import MVSEngine, run_mvs_stage
    engine = MVSEngine(cfg, weights_path=ck, device="cpu")
    sc = cascade_sc(cfg, data_root)
    stages = []
    for stage in range(3):
        outs, extras = run_mvs_stage(cfg, engine, sc, stage)
        sc["outs_samples"], sc["extras"] = outs, extras
        stages.append([({k: np.asarray(o[k] if not torch.is_tensor(o[k])
                                       else o[k].numpy())
                         for k in ("depth", "photometric_confidence",
                                   "prob_volume", "depth_values")},
                        None if e is None else e.numpy())
                       for o, e in zip(outs, extras)])
    return stages


def cascade_checks(spec):
    """Each model's three stages one view a rank."""
    return {m: cascade_stages(cfg, ck, spec["data"])
            for m, (cfg, ck) in spec["models"].items()}


def _recording(written):
    """Wrap the functions that write the pipeline's files so that each
    call's path lands in `written`."""
    from s_volsdf_tpu_torch.engine import fusion, runner, trainer
    from s_volsdf_tpu_torch.utils import checkpoint
    patched = []
    for mod, name in ((runner, "save_pfm"), (runner, "write_png"),
                      (runner, "write_cam"), (runner, "save_config"),
                      (trainer, "save_config"), (trainer, "write_png"),
                      (checkpoint, "save_state"), (fusion, "save_ply")):
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, **k):
            path = a[0] if isinstance(a[0], str) else a[1]
            written.append(os.path.relpath(path, written_root[0]))
            return _fn(*a, **k)
        setattr(mod, name, wrapper)
        patched.append((mod, name, fn))
    return patched


written_root = [None]


def cli_checks(spec):
    """cli.run.main on the fixture; the paths this rank wrote."""
    from s_volsdf_tpu_torch.cli import run as trun
    torch.set_flush_denormal(True)
    written = []
    written_root[0] = spec["root"]
    patched = _recording(written)
    try:
        plys = trun.main(spec["argv"], device="cpu")
    finally:
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    return {"written": written, "plys": plys}
