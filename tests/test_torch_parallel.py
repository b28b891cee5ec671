"""The port's multi-device training and renders on the CPU: ranks spawned
over gloo (`parallel.mesh.run_local_ranks`, a FileStore in a temporary
directory, one torch thread a rank, a join timeout), held against the
JAX package, which runs the same layouts on its virtual CPU devices, and
against the port's own one-process runs.

The ranks run tests/torch_parallel_ranks.py: once at 2 ranks for the
whole module (`two_ranks`) and once at 4 (`four_ranks`).

Tolerances and why:
  * the sharded step against JAX's `train_step` on the whole batch and
    jitter feed: test_torch_train_step.py's one-step bars (loss rtol
    1e-4; each gradient leaf rtol 1e-3, atol 1e-5). Every loss term is a
    per-ray mean, so the mean of the two halves' means is the whole
    batch's; PSNR is averaged over the ranks and only logged.
  * against the port's one-process step: the loss within 1e-6 and the
    whole gradient within 1e-6 relative in L2 (the halves' sums in
    another order; a scalar leaf, beta, moves by 1.03e-6 of itself).
  * the replicas, the NaN guard, rerun, resume, the scene layout and the
    renders: bit for bit. 2 scenes over 4 ranks against each scene's
    2-rank loop: the lockstep step's products batch the scenes (its
    losses equal, its parameters within an ulp a step, as in
    test_torch_multiscene.py): rtol 1e-5.
  * the sharded renders against JAX's mesh-sharded render: 2e-4 (the
    renders' bar, tests/test_torch_render_image.py).
"""

import dataclasses
import logging
import os

import jax
import numpy as np
import pytest
import torch

from s_volsdf_tpu import config as jconfig
from s_volsdf_tpu.engine import multiscene as jmultiscene
from s_volsdf_tpu.engine import train_step as jts
from s_volsdf_tpu.engine.render import render_depth as jrender_depth
from s_volsdf_tpu.engine.render import render_image as jrender_image
from s_volsdf_tpu.parallel.mesh import make_mesh
from s_volsdf_tpu.parallel.multihost import partition_scenes as jpartition
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.bridge import from_jax_params
from s_volsdf_tpu_torch.engine import multiscene as tmultiscene
from s_volsdf_tpu_torch.engine import train_step as tts
from s_volsdf_tpu_torch.engine.mesh import eval_sdf_grid, mesh_sdf_fn
from s_volsdf_tpu_torch.engine.render import render_depth, render_image
from s_volsdf_tpu_torch.parallel import mesh as pmesh
from s_volsdf_tpu_torch.parallel.multihost import partition_scenes
from test_torch_config import (IMG_RES, N_RAYS, params_pair,
                               scene_and_volumes, small_configs)
from test_torch_train_step import _batches, _leaf

import torch_parallel_ranks as ranks

CHUNK = 96          # 24x32 = 8 chunks; the grid's last launch is ragged
RENDER_TOL = 2e-4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _numpy_batch(tb):
    out = {k: v.numpy() for k, v in tb.items() if k != "jitter"}
    out["jitter"] = {k: v.numpy() for k, v in tb["jitter"].items()}
    return out


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    jcfg, tcfg = small_configs()
    jp, _ = params_pair(jcfg, seed=1)
    scene, prob, z_slab = scene_and_volumes()
    grid = np.random.default_rng(0).uniform(-1, 1, (1000, 3))
    spec = {"cfg": tcfg, "params": jax.tree.map(np.asarray, jp),
            "mvs": (prob, z_slab, scene.intrinsics, scene.poses,
                    scene.img_res),
            "img_res": IMG_RES, "iter_step": 5,
            "batches": [_numpy_batch(tb) for _, tb in _batches(3, seed=21)],
            "tmp": str(tmp_path_factory.mktemp("parallel")),
            "view": (scene.poses[0], scene.intrinsics[0], IMG_RES),
            "chunk": CHUNK, "fast": -1, "grid": grid.astype(np.float32)}
    return jcfg, jp, spec


@pytest.fixture(scope="module")
def two_ranks(setup):
    _, _, spec = setup
    # A one-process run's checkpoint, for the ranks to resume.
    solo = ranks.trainer(spec["cfg"], spec,
                         exps_root=os.path.join(spec["tmp"], "solo"))
    solo.run(3)
    out = pmesh.run_local_ranks(ranks.two_rank_checks, 2, spec, timeout=300)
    return out, solo


@pytest.fixture(scope="module")
def four_ranks(setup):
    _, _, spec = setup
    return pmesh.run_local_ranks(ranks.four_rank_checks, 4, spec,
                                 timeout=300)


def test_parallel_config_matches_jax():
    """ParallelConfig's fields and defaults are JAX's, and parallel.*
    overrides reach it as JAX's loader parses them."""
    t, j = tconfig.ParallelConfig(), jconfig.ParallelConfig()
    assert ([f.name for f in dataclasses.fields(t)]
            == [f.name for f in dataclasses.fields(j)])
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    overrides = ["parallel.shard_rays=false", "parallel.mesh_shape=[2,-1]",
                 "parallel.mesh_axes=[scene,rays]",
                 "parallel.shard_eval=false",
                 "parallel.shard_mvs_views=true"]
    tc = tconfig.load_config("dtu", overrides)
    jc = jconfig.load_config("dtu", overrides=overrides)
    assert dataclasses.asdict(tc.parallel) == \
        dataclasses.asdict(jc.parallel)
    for value in ("false", "null"):
        tconfig.apply_override(tc, "parallel.shard_mvs_views", value)
        jconfig.apply_override(jc, "parallel.shard_mvs_views", value)
        assert tc.parallel.shard_mvs_views == jc.parallel.shard_mvs_views


def test_partition_scenes_matches_jax():
    scans = [f"scan{i}" for i in range(11)]
    for count in (1, 2, 3, 4):
        for index in range(count):
            assert partition_scenes(scans, index, count) == \
                jpartition(scans, index, count)
    assert partition_scenes(scans) == scans   # one process


def _picks(fn, name):
    """The "multiscene:" lines that fn logs on logger `name` (the JAX
    package's does not propagate)."""
    records = ranks._Records()
    logger = logging.getLogger(name)
    level = logger.level
    logger.addHandler(records)
    logger.setLevel(logging.INFO)
    try:
        fn()
    finally:
        logger.removeHandler(records)
        logger.setLevel(level)
    return [x for x in records.lines if x.startswith("multiscene:")]


@pytest.mark.parametrize("shard_rays", [True, False])
def test_pick_loop_mirrors_jax(shard_rays, monkeypatch):
    """The layout `_pick_loop` picks for S scenes on n ranks is the one
    the JAX package picks on n devices (the same log line), over a grid
    of (S, n)."""
    jcfg, tcfg = small_configs()
    jcfg.train.num_pixels = tcfg.train.num_pixels = 64
    jcfg.parallel.shard_rays = tcfg.parallel.shard_rays = shard_rays
    devices = jax.devices()
    kinds = set()
    for n in (1, 2, 3, 4, 8):
        monkeypatch.setattr(jax, "devices", lambda *a, n=n: devices[:n])
        for S in (1, 2, 3, 4, 5, 8, 10, 16):
            want = _picks(lambda: jmultiscene._pick_loop(
                jcfg, S, use_mvs=False, n_views=3, img_res=IMG_RES),
                "s_volsdf_tpu")
            layout = []
            got = _picks(lambda: layout.append(
                tmultiscene._pick_loop(tcfg, S, n)), "s_volsdf_tpu_torch")
            assert got == want, (S, n)
            kinds.add(layout[0].kind)
    assert kinds == ({"scene", "scene_rays", "lockstep"} if shard_rays
                     else {"scene", "lockstep"})


def test_sharded_step_matches_jax(setup, two_ranks):
    """2 ranks, each with its half of the batch and of the jitter feed,
    against JAX's step on the whole batch and feed."""
    jcfg, jp, spec = setup
    (r0, r1), _ = two_ranks
    scene, prob, z_slab = scene_and_volumes()
    from test_torch_config import mvs_pair
    jm, _ = mvs_pair(scene, prob, z_slab)
    (jb, _), = _batches(1, seed=21)
    grad_fn = jax.jit(jax.grad(jts._loss_fn, has_aux=True),
                      static_argnums=(1,))
    jgrads, jlo = grad_fn(jp, jcfg, jb, jax.random.PRNGKey(0), jm,
                          jax.numpy.asarray(spec["iter_step"], jax.numpy.int32))
    np.testing.assert_allclose(r0["loss"], float(jlo.loss), rtol=1e-4)
    assert r0["step_loss"] == r0["loss"] and r0["step_finite"] == 1.0
    names = [n for n, _ in from_jax_params(spec["params"]).named_parameters()]
    for name, g0, g1 in zip(names, r0["grads"], r1["grads"]):
        np.testing.assert_array_equal(g0, g1)
        np.testing.assert_allclose(g0, np.asarray(_leaf(jgrads, name)),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_sharded_step_matches_one_process(setup, two_ranks):
    _, _, spec = setup
    (r0, _), _ = two_ranks
    state = ranks.fresh_state(spec["cfg"], spec)
    grads, lo = tts.loss_and_grads(state.params, spec["cfg"],
                                   ranks.batch_of(spec["batches"][0]), None,
                                   ranks.volumes(spec), spec["iter_step"])
    np.testing.assert_allclose(r0["loss"], float(lo.loss.detach()), rtol=1e-6)
    got = np.concatenate([g.ravel() for g in r0["grads"]])
    want = np.concatenate([g.numpy().ravel() for g in grads])
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    print(f"sharded vs one-process gradient: {err:.3g} relative (L2)")
    assert err <= 1e-6, err


def test_replicas_bit_equal(two_ranks):
    (r0, r1), _ = two_ranks
    for a, b in zip(r0["replica"], r1["replica"]):
        np.testing.assert_array_equal(a, b)


def test_nan_guard_acts_on_every_rank(two_ranks):
    """NaN in the last rank's rows only: both ranks skip the update,
    their parameters and Adam state unchanged to the bit."""
    for r in two_ranks[0]:
        assert r["nan_finite"] == 0.0
        assert r["nan_params_kept"] and r["nan_adam_kept"]
        assert r["nan_iter_step"] == tconfig.dtu_config().loss.anneal_rgb + 12


def test_sharded_draws(setup, two_ranks):
    """Every rank draws the step's view alike and its own rows of the
    pixels and noise: one process's draws of the whole batch."""
    _, _, spec = setup
    (r0, r1), _ = two_ranks
    cfg = spec["cfg"]
    scene = ranks.trainer(cfg, spec).scene_tensors()
    whole = tts.draw_step_inputs(scene, torch.Generator().manual_seed(3),
                                 cfg=cfg, n_views=3, img_res=IMG_RES,
                                 n_rays=N_RAYS)
    np.testing.assert_array_equal(r0["draw_view"], r1["draw_view"])
    assert not np.array_equal(r0["draw_uv"], r1["draw_uv"])
    half = N_RAYS // 2
    for i, r in enumerate((r0, r1)):
        rows = slice(i * half, (i + 1) * half)
        np.testing.assert_array_equal(r["draw_uv"], whole["uv"][:, rows])
        np.testing.assert_array_equal(r["draw_t_rand"],
                                      whole["jitter"]["t_rand"][rows])


def test_sharded_loop_rerun_and_resume(two_ranks):
    (r0, r1), _ = two_ranks
    assert r0["loop_group"] and r1["loop_group"]
    for r in (r0, r1):
        for key in ("again", "resumed"):
            for a, b in zip(r["whole"], r[key]):
                np.testing.assert_array_equal(a, b, err_msg=key)
    for a, b in zip(r0["whole"], r1["whole"]):
        np.testing.assert_array_equal(a, b)
    assert all(np.isfinite(r0["whole_losses"]))


def test_checkpoints_cross_layouts(setup, two_ranks):
    """A one-process checkpoint resumes on the ranks, and the ranks'
    checkpoint (written once, by the first) in one process."""
    _, _, spec = setup
    rs, solo = two_ranks
    for r in rs:
        assert r["solo_step"] == 3
        for a, b in zip(r["solo_params"], ranks.params_np(solo.state.params)):
            np.testing.assert_array_equal(a, b)
    one = ranks.trainer(spec["cfg"], spec,
                        exps_root=os.path.join(spec["tmp"], "whole"),
                        is_continue=True)
    assert one.state.iter_step == 6
    for a, b in zip(ranks.params_np(one.state.params), rs[0]["whole"]):
        np.testing.assert_array_equal(a, b)
    runs = os.listdir(os.path.join(spec["tmp"], "whole", "exps_vsdf",
                                   "ours_106"))
    assert len(runs) == 1, runs


def test_indivisible_rays(two_ranks):
    """An indivisible num_pixels raises in make_sharded_scan_train_fn; in
    the trainer it warns and picks the single-rank loop."""
    for r in two_ranks[0]:
        assert r["indivisible_raises"]
        assert r["indivisible_group"] is None
        assert any("falling back to single-device loop" in line
                   for line in r["indivisible_log"])


def test_scenes_over_ranks_equal_one_process(setup, two_ranks):
    """4 scenes over 2 ranks (2 a rank, no collective): each scene, on
    every rank, equals the one-process lockstep run of the 4 to the
    bit: parameters, Adam state, losses, generator."""
    _, _, spec = setup
    trainers = [ranks.trainer(dataclasses.replace(spec["cfg"],
                                                          seed=s), spec)
                for s in range(4)]
    tmultiscene.run_joint(trainers, 4, chunk_steps=2)
    for r in two_ranks[0]:
        for s, t in enumerate(trainers):
            for a, b in zip(r["scenes"][s], ranks.params_np(t.state.params)):
                np.testing.assert_array_equal(a, b)
            assert r["scene_losses"][s] == [lo.loss for lo in t.losses]
            for x, y in zip(r["scene_adam"][s], ranks.adam_np(t.tx)):
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k])
            np.testing.assert_array_equal(r["scene_gen"][s],
                                          t.gen.get_state().numpy())


def test_scene_rays_layout_equals_pair_loops(four_ranks):
    """2 scenes over 4 ranks (a 2 x 2 scene x rays mesh): each scene, on
    every rank, tracks its 2-rank ray-sharded loop."""
    for r in four_ranks:
        pair = next(x for x in four_ranks if x["scene"] == r["scene"])
        s = r["scene"]
        np.testing.assert_allclose(r["joint_losses"][s], pair["pair_losses"],
                                   rtol=1e-5)
        for a, b in zip(r["joint"][s], pair["pair"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)


def test_sharded_renders_equal_one_rank(setup, two_ranks):
    """render_image, render_depth and eval_sdf_grid over 2 ranks equal
    the one-process results; the renders agree with JAX's mesh-sharded
    render."""
    jcfg, jp, spec = setup
    cfg = spec["cfg"]
    params = from_jax_params(spec["params"])
    pose, intr, res = spec["view"]
    image = render_image(params, cfg.model, pose, intr, res, chunk=CHUNK,
                         fast=-1)
    depth = render_depth(params, cfg.model, pose, intr, res, chunk=CHUNK,
                         fast=-1)
    grid = eval_sdf_grid(mesh_sdf_fn(params, cfg.model,
                                     cfg.model.scene_bounding_sphere),
                         spec["grid"], chunk=CHUNK)
    for r in two_ranks[0]:
        for k in image:
            np.testing.assert_array_equal(r["image"][k], image[k], err_msg=k)
        for k in depth:
            np.testing.assert_array_equal(r["depth"][k], depth[k], err_msg=k)
        np.testing.assert_array_equal(r["grid"], grid)
    mesh = make_mesh((2,), ("rays",), devices=jax.devices()[:2])
    jimage = jrender_image(jp, jcfg.model, pose, intr, res, chunk=CHUNK,
                           fast=-1, mesh=mesh)
    jdepth = jrender_depth(jp, jcfg.model, pose, intr, res, chunk=CHUNK,
                           fast=-1, mesh=mesh)
    r0 = two_ranks[0][0]
    for k in ("rgb", "depth", "acc"):
        np.testing.assert_allclose(r0["image"][k], jimage[k],
                                   atol=RENDER_TOL, err_msg=k)
    np.testing.assert_allclose(r0["depth"]["depth"], jdepth["depth"],
                               atol=RENDER_TOL)


def test_eval_group_gates(two_ranks):
    """eval_group follows eval_mesh's gates: on when shard_eval and the
    chunk divides over the ranks; None otherwise, and with a mesh_shape
    sized to one rank."""
    for r in two_ranks[0]:
        assert r["gates"] == {"on": (0, 1), "indivisible": None,
                              "off": None, "one_rank": None}
