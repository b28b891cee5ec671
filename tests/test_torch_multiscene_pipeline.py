"""save_depth_multiscene, the port's multi-scene pipeline, against the
port's serial save_depth, at the JAX package's own test's size
(tests/test_multiscene_pipeline.py: 64x96 DTU fixtures scan106 and
scan114, the cascade at (16, 8, 8) hypotheses, 30 float32 VolSDF steps
at stage 0 on a small model). Each scene draws from its own generator in
the serial order, so the trajectories are the serial ones up to the
batched products' sums; the bar is the JAX test's: at least 99.5% of
every view's depth pixels within 1e-3. Also the override groups against
the JAX package's, the command line's `multiscene` knob, and a joint
run's checkpoint resumed by a serial trainer.
"""

import copy
import os

import numpy as np
import pytest
import torch

from s_volsdf_tpu import config as jconfig
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.cli import run as trun
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.data.io import read_pfm
from s_volsdf_tpu_torch.data.scene_dataset import load_scene
from s_volsdf_tpu_torch.engine import multiscene
from s_volsdf_tpu_torch.engine.runner import save_depth
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from s_volsdf_tpu_torch.utils import checkpoint as tckpt

SCANS = ["scan106", "scan114"]
VIEWS = (25, 22, 28)
STEPS = 30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread, and subnormal floats flushed to zero while this
    module runs: the feedback renders' plain SDF MLP (softplus with beta
    100) makes subnormal exp(-|z|) values, which the CPU's log1p and exp
    take on their slow path (a 64x96 render 9.1 s, 5.5 s flushed). The
    joint and the serial run compute alike either way."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


def _cfg(data_root, outdir):
    """The JAX pipeline test's overrides, in the port's config."""
    return tconfig.load_config("dtu", overrides=[
        "data_dir_root=" + data_root, "dataset.data_dir_root=" + data_root,
        "max_h=64", "max_w=96", "dataset.img_res=[64,96]",
        "mvs.ndepths=[16,8,8]", "mvs.numdepth=16", "mvs.x2_mvsres=false",
        f"opt_stepNs=[{STEPS},0,0]", "train.num_pixels=64",
        "train.render_freq=-1",
        "model.implicit.dims=[32,32]", "model.implicit.skip_in=[]",
        "model.rendering.dims=[32]", "model.feature_vector_size=32",
        "model.sampler.N_samples=8", "model.sampler.N_samples_eval=16",
        "model.sampler.N_samples_extra=4", "loss.anneal_rgb=10",
        "train.train_compute_dtype=float32",
        "train.train_activation_dtype=float32",
        "train.mvs_pack_dtype=float32", "mvs.compute_dtype=float32",
        "outdir=" + outdir])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The joint and the serial run of both scans; returns (root,
    data_root, the joint run's results)."""
    root = str(tmp_path_factory.mktemp("ms_pipe"))
    data_root = os.path.join(root, "data")
    for scan in SCANS:
        make_dtu_fixture(data_root, scan_id=int(scan[4:]), img_res=(64, 96))
    joint = multiscene.save_depth_multiscene(
        _cfg(data_root, "exps_joint"), SCANS,
        exps_root=os.path.join(root, "joint"), device="cpu")
    save_depth(_cfg(data_root, "exps_serial"), SCANS,
               exps_root=os.path.join(root, "serial"), device="cpu")
    return root, data_root, joint


def _depth(root, run, scan, view):
    d, _ = read_pfm(os.path.join(root, run, f"exps_{run}", scan,
                                 f"depth_est/{view:08d}.pfm"))
    return d


@pytest.mark.parametrize("scan", SCANS)
def test_multiscene_matches_serial(runs, scan):
    root, _, joint = runs
    assert joint[scan]["trainer"].state.iter_step == STEPS
    for v in VIEWS:
        dj = _depth(root, "joint", scan, v)
        ds = _depth(root, "serial", scan, v)
        assert np.isfinite(dj).all()
        close = np.isclose(dj, ds, rtol=1e-3, atol=1e-3)
        assert close.mean() >= 0.995, \
            f"{scan} view {v}: {100 * (1 - close.mean()):.2f}% mismatch"


def test_override_groups_match_jax(tmp_path):
    """[scan24, scan37, scan106, scan114]: the port's groups are the JAX
    package's (its per-scan overrides keyed by repr)."""
    scans = ["scan24", "scan37", "scan106", "scan114"]
    jcfg = jconfig.load_config("dtu")
    jgroups = {}
    for scan in scans:
        key = repr(jconfig.per_scene_overrides(jcfg, scan))
        jgroups.setdefault(key, []).append(scan)
    groups = multiscene.override_groups(tconfig.load_config("dtu"), scans)
    assert [g for _, g in groups] == list(jgroups.values())
    assert len(groups) > 1 and ["scan106", "scan114"] in list(
        jgroups.values())


@pytest.mark.parametrize("knob", ["true", "false"])
def test_multiscene_knob_is_live(knob, tmp_path, monkeypatch):
    """cli.run with multiscene=true and two scans reaches
    save_depth_multiscene; with false, save_depth."""
    called = []
    monkeypatch.setattr(trun, "save_depth_multiscene",
                        lambda cfg, t, **kw: called.append(("joint", t)))
    monkeypatch.setattr(trun, "save_depth",
                        lambda cfg, t, **kw: called.append(("serial", t)))
    monkeypatch.setattr(trun, "pcd_filter", lambda *a, **k: [])
    trun.main([f"multiscene={knob}", "testlist=scan106,scan114",
               f"outdir={tmp_path}"], device="cpu")
    want = "joint" if knob == "true" else "serial"
    assert called == [(want, ["scan106", "scan114"])]


def test_joint_checkpoint_resumes_serially(runs):
    """Each scene's "latest" checkpoint of the joint run loads into a
    serial VolTrainer (is_continue) with the joint trainer's parameters,
    Adam state and iter_step."""
    root, data_root, joint = runs
    cfg = _cfg(data_root, "exps_joint")
    cfg.is_continue = True
    for scan in SCANS:
        scene = load_scene(cfg.dataset.data_dir, tuple(cfg.dataset.img_res),
                           int(scan[4:]), cfg.num_view, cfg.data_dir_root)
        resumed = VolTrainer(copy.deepcopy(cfg), scene, scan, device="cpu",
                             exps_root=os.path.join(root, "joint"),
                             is_continue=True)
        mine = joint[scan]["trainer"]
        assert resumed.state.iter_step == mine.state.iter_step == STEPS
        assert resumed.epoch == mine.epoch
        for a, b in zip(tckpt.train_state_leaves(resumed.state),
                        tckpt.train_state_leaves(mine.state)):
            np.testing.assert_array_equal(a, b)
        assert torch.equal(resumed.gen.get_state(), mine.gen.get_state())
