"""The port's checkpoints against the JAX package's (utils/checkpoint.py,
the trainer's run directory, resume and snapshot schedule).

- The leaf order: the port's list of TrainState leaves names the same
  leaves, in the same order, as `jax.tree_util.tree_flatten` of the JAX
  `init_train_state` (131 at the dtu width: 43 params, Adam's count, mu
  and nu, iter_step).
- A port checkpoint (two steps taken) loads in JAX `load_state` into a
  JAX TrainState template, and a JAX checkpoint (every leaf random)
  loads into the port: every leaf bit-equal, count and iter_step int32.
- A port resume continues bit for bit: two steps, save, load into a
  fresh trainer (is_continue), two more steps equal four uninterrupted
  steps (losses and parameters exactly), the generator included.
- The snapshot labels ("latest", "epoch_<n>") and plot-render steps of
  a run equal the JAX trainer's for the same steps, chunk size, views
  and checkpoint_freq (the chunk function stubbed on both sides).
- run.yaml, read with PyYAML, equals the JAX config's run.yaml on every
  key the port's config has; each new config key is live.
- utils/tracing.PhaseTimer sums phases and writes a profiler trace.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from s_volsdf_tpu import config as jconfig
from s_volsdf_tpu.data.scene_dataset import SceneData as JSceneData
from s_volsdf_tpu.engine import trainer as jtrainer
from s_volsdf_tpu.engine.train_step import (init_train_state,
                                            make_optimizer as jmake_optimizer)
from s_volsdf_tpu.models.loss import LossOutput as JLossOutput
from s_volsdf_tpu.models.network import init_volsdf_params as jinit_params
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
from s_volsdf_tpu_torch.engine import trainer as ttrainer
from s_volsdf_tpu_torch.models.loss import LossOutput
from s_volsdf_tpu_torch.models.network import init_volsdf_params
from s_volsdf_tpu_torch.utils import checkpoint as tckpt
from test_torch_config import IMG_RES, VOL, _port_fields, small_configs

SCAN = "scan106"
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_names(params):
    """The port's leaf names ("sdf.0.v", "count", "mu.sdf.0.v", ...) in
    `train_state_leaves`' order."""
    by_id = {id(p): n for n, p in params.named_parameters()}
    names = [by_id[id(p)] for p in tckpt.param_leaves(params)]
    return (names + ["count"] + [f"mu.{n}" for n in names]
            + [f"nu.{n}" for n in names] + ["iter_step"])


def _jax_names(state):
    names = []
    for path, _ in jax.tree_util.tree_flatten_with_path(state)[0]:
        keys = []
        for k in path:
            if isinstance(k, jax.tree_util.DictKey):
                keys.append(str(k.key))
            elif isinstance(k, jax.tree_util.SequenceKey):
                keys.append(str(k.idx))
            elif isinstance(k, jax.tree_util.GetAttrKey):
                keys.append(k.name)
        if keys[0] == "params":
            names.append(".".join(keys[1:]))
        elif keys[0] == "opt_state":      # opt_state.<i>.<j>.count|mu|nu...
            tail = keys[1:]
            while tail[0].isdigit():      # the chain's and adam's indices
                tail = tail[1:]
            names.append(".".join(tail))
        else:
            names.append(keys[0])
    return names


def test_leaf_order_is_jax_flatten_order():
    for jcfg, tcfg in ((jconfig.dtu_config(), tconfig.dtu_config()),
                       small_configs()):
        jstate = init_train_state(jcfg, jinit_params(
            jax.random.PRNGKey(0), jcfg.model), jmake_optimizer(jcfg))
        tparams = init_volsdf_params(torch.Generator().manual_seed(0),
                                     tcfg.model)
        want = _jax_names(jstate)
        assert _port_names(tparams) == want
        if jcfg.model.implicit.dims == (256,) * 8:
            assert len(want) == 131


def _trainer(cfg, exps_root=None, is_continue=False, chunk_steps=1):
    scene = make_sphere_scene(3, IMG_RES)
    trainer = ttrainer.VolTrainer(
        cfg, scene_from_synthetic(scene), SCAN if exps_root else None,
        device="cpu", exps_root=exps_root, is_continue=is_continue,
        chunk_steps=chunk_steps)
    trainer.mvs = chip_smoke.make_volumes(scene, VOL, "cpu")
    return trainer


def _jax_template(jcfg):
    params = jinit_params(jax.random.PRNGKey(0), jcfg.model)
    return init_train_state(jcfg, params, jmake_optimizer(jcfg))


def test_port_checkpoint_loads_in_jax(tmp_path):
    jcfg, tcfg = small_configs()
    trainer = _trainer(tcfg, str(tmp_path))
    trainer.run(STEPS)
    path = os.path.join(trainer.checkpoints_path, "latest")
    want = tckpt.train_state_leaves(trainer.state)
    template = _jax_template(jcfg)
    state, meta = jckpt.load_state(path, template)
    got, _ = jax.tree_util.tree_flatten(state)
    tmpl, _ = jax.tree_util.tree_flatten(template)
    assert len(got) == len(want) == len(tmpl)
    for g, w, t in zip(got, want, tmpl):
        assert g.dtype == np.asarray(t).dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert int(state.opt_state[1][0].count) == STEPS
    assert int(state.iter_step) == STEPS
    assert meta["epoch"] == trainer.epoch and "rng" not in meta


def test_jax_checkpoint_loads_in_port(tmp_path):
    jcfg, tcfg = small_configs()
    template = _jax_template(jcfg)
    leaves, treedef = jax.tree_util.tree_flatten(template)
    rng = np.random.default_rng(3)
    rand = [np.asarray(rng.standard_normal(np.shape(x)), np.float32)
            for x in leaves]
    n = (len(leaves) - 2) // 3
    rand[n] = np.asarray(7, np.int32)            # count
    rand[-1] = np.asarray(11, np.int32)          # iter_step
    rand[2 * n + 1:3 * n + 1] = [np.abs(x) for x in rand[2 * n + 1:3 * n + 1]]
    jstate = jax.tree_util.tree_unflatten(treedef, rand)
    run = tmp_path / tconfig.Config().exps_folder / f"ours_{SCAN[4:]}" / "t0"
    jckpt.save_state(str(run / "checkpoints" / "latest"), jstate, epoch=5,
                     rng=[1, 2])
    trainer = _trainer(tcfg, str(tmp_path), is_continue=True)
    assert trainer.rundir == str(run)
    got = tckpt.train_state_leaves(trainer.state)
    for g, w in zip(got, rand):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert trainer.state.iter_step == 11 and trainer.epoch == 5
    # No torch generator state in a JAX checkpoint: reseeded from seed + 1.
    want = torch.Generator().manual_seed(tcfg.seed + 1).get_state()
    assert torch.equal(trainer.gen.get_state(), want)


def test_resume_continues_bit_for_bit(tmp_path):
    _, tcfg = small_configs()
    whole = _trainer(tcfg)
    whole.run(2 * STEPS)
    first = _trainer(tcfg, str(tmp_path))
    first.run(STEPS)
    assert sorted(os.listdir(first.checkpoints_path)) == [
        f"epoch_{first.epoch}", "latest"]
    resumed = _trainer(tcfg, str(tmp_path), is_continue=True)
    assert resumed.rundir == first.rundir
    assert resumed.state.iter_step == STEPS
    assert torch.equal(resumed.gen.get_state(), first.gen.get_state())
    resumed.run(STEPS)
    assert [lo.loss for lo in resumed.losses] == \
        [lo.loss for lo in whole.losses[STEPS:]]
    for a, b in zip(tckpt.train_state_leaves(resumed.state),
                    tckpt.train_state_leaves(whole.state)):
        np.testing.assert_array_equal(a, b)


def _stub_losses(n, finite):
    return [LossOutput(*(torch.tensor(0.5),) * 6, grad_finite=finite)
            for _ in range(n)]


@pytest.mark.parametrize("steps,chunk,freq", [(13, 2, 1), (120, 1, 2),
                                               (7, 5, 100)])
def test_snapshot_schedule_matches_jax(tmp_path, steps, chunk, freq):
    """Both trainers with their chunk function stubbed (no step runs):
    the same checkpoint labels and plot-render steps, in order."""
    jcfg, tcfg = small_configs()
    for cfg in (jcfg, tcfg):
        cfg.train.checkpoint_freq = freq
        cfg.train.render_freq = 1
    syn = make_sphere_scene(3, IMG_RES)
    V = syn.images.shape[0]
    rgb = syn.images.reshape(V, -1, 3)
    js = JSceneData(data_dir="DTU", scan_id=106, img_res=IMG_RES,
                    num_views=3, intrinsics=syn.intrinsics, poses=syn.poses,
                    rgb=rgb, rgb_smooth=rgb, masks=np.ones_like(rgb),
                    scale_factor=1.0, scale_mat=None)
    js.trains_ids = lambda: [0, 1, 2]
    js.eval_ids = lambda: []
    jt = jtrainer.VolTrainer(jcfg, js, SCAN, exps_root=str(tmp_path / "j"),
                             chunk_steps=chunk)
    tt = _trainer(tcfg, str(tmp_path / "t"), chunk_steps=chunk)
    record = {"jax": [], "port": []}
    for side, tr in (("jax", jt), ("port", tt)):
        tr.save_checkpoint = lambda label="latest", s=side: \
            record[s].append(label)
        tr._plot_render = lambda step, s=side: record[s].append(f"plot{step}")

    def jchunk(state, rngs, scene, mvs):
        n = len(rngs)
        ones = np.ones(n, np.float32)
        return state, JLossOutput(*(ones * 0.5,) * 6, grad_finite=ones)

    def tchunk(state, n, scene, mvs, gen):
        return state, _stub_losses(n, 1.0), [0.0] * n

    jt._get_loop = lambda use_mvs: jchunk
    tt._get_loop = lambda use_mvs: tchunk
    tt.mvs = None
    jt.run(steps)
    tt.run(steps)
    assert record["port"] == record["jax"]
    assert tt.epoch == jt.epoch and tt.last_guard_trips == 0


def _yaml_view(x):
    if isinstance(x, tuple):
        return [_yaml_view(v) for v in x]
    if dataclasses.is_dataclass(x):
        return {f.name: _yaml_view(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    return x


@pytest.mark.parametrize("overrides", [[], ["train.expname=x",
                                            "plot.grid_boundary=[-2,2]",
                                            "is_continue=true",
                                            "train.checkpoint_freq=3"]])
def test_run_yaml_matches_jax(tmp_path, overrides):
    tcfg = tconfig.load_config("dtu", overrides=overrides)
    jcfg = jconfig.load_config("dtu", overrides=overrides)
    tconfig.save_config(tcfg, str(tmp_path / "t" / "run.yaml"))
    jconfig.save_config(jcfg, str(tmp_path / "j" / "run.yaml"))
    with open(tmp_path / "t" / "run.yaml") as f:
        got = yaml.safe_load(f)
    with open(tmp_path / "j" / "run.yaml") as f:
        want = yaml.safe_load(f)
    assert got == _yaml_view(tcfg)

    def pick(port, jax_d):        # the JAX file on the port's keys
        return {k: pick(v, jax_d[k]) if isinstance(v, dict) else jax_d[k]
                for k, v in port.items()}
    assert got == pick(got, want)
    assert len(list(_port_fields(tcfg, jcfg))) > 60


# Keys the JAX package carries for parity and reads nowhere (its plots are
# fixed-size render panels; its eval command line has its own
# --split_n_pixels): changing one changes the run.yaml written, only.
PARITY_ONLY = {"plot.plot_nimgs": "3", "plot.resolution": "64",
               "train.plot_freq": "7", "train.split_n_pixels": "99"}


def _with(cfg, key, value):
    cfg = tconfig.load_config("dtu", overrides=[]) if cfg is None else cfg
    tconfig.apply_override(cfg, key, value)
    return cfg


def _mesh_of(tcfg, tmp_path, name):
    from s_volsdf_tpu_torch.engine.eval_nvs import export_mesh
    scene = scene_from_synthetic(make_sphere_scene(3, IMG_RES))
    params = init_volsdf_params(torch.Generator().manual_seed(0), tcfg.model)
    out = export_mesh(tcfg, scene, params, str(tmp_path / f"{name}.ply"),
                      resolution=16)
    with open(out, "rb") as f:
        return f.read()


@pytest.mark.parametrize("key", ["is_continue", "train.expname",
                                 "train.checkpoint_freq", "train.render_freq",
                                 "train.ckpt_backend", "plot.grid_boundary",
                                 "plot.level"] + sorted(PARITY_ONLY))
def test_new_key_is_live(key, tmp_path):
    """Each config key this slice adds, changed alone, changes what the
    port writes or renders (or, for the keys the JAX package never reads,
    the run.yaml it writes)."""
    def cfg():
        return small_configs()[1]

    if key == "is_continue":
        from s_volsdf_tpu_torch.engine.runner import setup_scene
        data = str(tmp_path / "data")
        from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
        make_dtu_fixture(data, scan_id=106, img_res=(32, 64))
        base = cfg()
        base.data_dir_root = base.dataset.data_dir_root = data
        base.max_h, base.max_w = base.dataset.img_res = (32, 64)
        base.mvs.ndepths, base.mvs.numdepth = (16, 8, 8), 16
        first = setup_scene(base, SCAN, exps_root=str(tmp_path),
                            device="cpu")["trainer"]
        first.run(2)
        resumed = setup_scene(_with(base, key, "true"), SCAN,
                              exps_root=str(tmp_path), device="cpu")["trainer"]
        fresh = setup_scene(_with(base, key, "false"), SCAN,
                            exps_root=str(tmp_path), device="cpu")["trainer"]
        assert (fresh.state.iter_step, resumed.state.iter_step) == (0, 2)
        assert resumed.rundir == first.rundir
    elif key == "train.expname":
        a = _trainer(cfg(), str(tmp_path))
        b = _trainer(_with(cfg(), key, "other"), str(tmp_path))
        assert os.path.basename(os.path.dirname(a.rundir)) == "ours_106"
        assert os.path.basename(os.path.dirname(b.rundir)) == "other_106"
    elif key == "train.checkpoint_freq":
        labels = []
        for i, freq in enumerate(("100", "1")):
            t = _trainer(_with(cfg(), key, freq), str(tmp_path / str(i)))
            t.run(6)
            labels.append(sorted(os.listdir(t.checkpoints_path)))
        assert labels == [["epoch_2", "latest"],
                          ["epoch_1", "epoch_2", "latest"]]
    elif key == "train.render_freq":
        plots = []
        for i, freq in enumerate(("0", "1")):
            t = _trainer(_with(cfg(), key, freq), str(tmp_path / str(i)))
            t.run(3)
            plots.append(sorted(os.listdir(t.plots_dir)))
        assert plots == [[], ["render_3.png"]]
    elif key == "train.ckpt_backend":
        _trainer(cfg(), str(tmp_path))
        with pytest.raises(NotImplementedError, match="orbax"):
            _trainer(_with(cfg(), key, "orbax"), str(tmp_path))
    elif key.startswith("plot."):
        value = "[-1.2,1.2]" if key == "plot.grid_boundary" else "0.05"
        if key in PARITY_ONLY:
            value = PARITY_ONLY[key]
        if key not in PARITY_ONLY:
            assert _mesh_of(cfg(), tmp_path, "a") != \
                _mesh_of(_with(cfg(), key, value), tmp_path, "b")
            return
    if key in PARITY_ONLY:
        a = _trainer(cfg(), str(tmp_path / "a"))
        b = _trainer(_with(cfg(), key, PARITY_ONLY[key]), str(tmp_path / "b"))
        docs = []
        for t in (a, b):
            with open(os.path.join(t.rundir, "run.yaml")) as f:
                docs.append(yaml.safe_load(f))
        section, name = key.split(".")
        assert docs[0][section][name] != docs[1][section][name]
        docs[1][section][name] = docs[0][section][name]
        assert docs[0] == docs[1]


def test_phase_timer_traces(tmp_path):
    """PhaseTimer sums each phase's seconds and calls and, given a trace
    directory, writes the phase's torch.profiler trace there."""
    from s_volsdf_tpu_torch.utils.tracing import PhaseTimer
    timer = PhaseTimer()
    for _ in range(2):
        with timer.phase("mm"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    with timer.phase("traced", trace_dir=str(tmp_path)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert timer.counts == {"mm": 2, "traced": 1}
    assert set(timer.report()) == {"mm", "traced"}
    with open(tmp_path / "traced.json") as f:
        assert "traceEvents" in f.read()
