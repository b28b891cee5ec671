"""The slice as a whole: both packages' `save_scene_depth` on one 64x96
DTU fixture, with the same cascade weights (the JAX engine's, loaded
into the port as a converted checkpoint) and the same VolSDF weights
(the JAX trainer's init, bridged into the port's trainer): the small
VolSDF of test_torch_config.shrink, ndepths (16, 8, 8), x2_mvsres off,
opt_stepNs (1, 0, 0) — stage 0's volumes go to the trainer, no step is
taken, and the VolSDF depth of every training view is rendered and fed
to stages 2 and 3.

Tolerances on every view's PFMs:
- depth_est: the bar is 1e-4 relative, held on at least 99% of the
  pixels, and rtol 1e-3 on every pixel. Measured: max 3.75e-4 relative
  (0.40 on a depth of ~1070), 0.34% of view 25's pixels past 1e-4.
  Why past 1e-4: the fed-back VolSDF depth is ill-conditioned in
  float32. The two renders of the same weights differ by up to 0.011
  (x200 in the fixture's units) on ~50 rays a view, where the
  error-bound sampler's discrete choices flip; the JAX render differs
  from itself by up to 0.089 on ~1,000 rays a view when the camera
  moves by 1e-6 relative. Stages 2 and 3 centre their hypotheses on
  that depth.
- confidence: atol 1e-5 on at least 99.9% of pixels (a pixel whose
  truncated hypothesis index differs between the two sides changes by
  a whole window). Measured max 7.5e-09, no such pixel.
- cam files: within 1e-5.

The port's PNG outputs: the depth and confidence visualisations equal
the JAX function's pixels of the port's own PFMs; the image copy is the
MVS sample's exact pixels (the JAX package's JPEG is within a mean
error of 2 levels of it).

A second test runs the port alone with three steps: finite losses,
depths inside the fixture's range.
"""

import os

import jax
import numpy as np
import pytest
import torch

from s_volsdf_tpu import config as jconfig
from s_volsdf_tpu.engine import runner as jrunner
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.data.io import read_pfm, read_png
from s_volsdf_tpu_torch.engine import runner as trunner
from s_volsdf_tpu_torch.engine import trainer as ttrainer
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import params_pair, shrink

RES = (64, 96)
VIEWS = (25, 22, 28)
DEPTH_RTOL = 1e-3       # every pixel
DEPTH_BAR = 1e-4        # at least 99% of the pixels
CONF_ATOL = 1e-5


def _configure(cfg, data_root, opt_steps):
    shrink(cfg)
    cfg.data_dir_root = cfg.dataset.data_dir_root = data_root
    cfg.max_h, cfg.max_w = RES
    cfg.dataset.img_res = RES
    cfg.mvs.ndepths = (16, 8, 8)
    cfg.mvs.numdepth = 16
    cfg.mvs.x2_mvsres = False
    cfg.opt_stepNs = opt_steps
    return cfg


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("runner") / "data")
    make_dtu_fixture(root, scan_id=106, img_res=RES)
    return root


@pytest.fixture(scope="module")
def both_runs(data_root, tmp_path_factory):
    out = tmp_path_factory.mktemp("runs")
    jcfg = _configure(jconfig.dtu_config(), data_root, (1, 0, 0))
    # One device, serial over views: the port's layout.
    jcfg.parallel.shard_rays = jcfg.parallel.shard_eval = False
    jcfg.parallel.shard_mvs_views = False
    tcfg = _configure(tconfig.dtu_config(), data_root, (1, 0, 0))

    jengine = jrunner.MVSEngine(jcfg, rng_seed=0)
    ck = str(out / "casmvsnet_ckpt")
    jckpt.save_state(ck, jax.tree.map(np.asarray, jengine.params),
                     model="casmvsnet")
    tengine = trunner.MVSEngine(tcfg, weights_path=ck, device="cpu")

    jdir, tdir = str(out / "jax"), str(out / "port")
    jrunner.save_scene_depth(jcfg, "scan106", exps_root=jdir, engine=jengine)
    _, tparams = params_pair(jcfg, seed=jcfg.seed)
    mp = pytest.MonkeyPatch()
    mp.setattr(ttrainer, "init_volsdf_params",
               lambda gen, mcfg, device: tparams.to(device))
    try:
        res = trunner.save_scene_depth(tcfg, "scan106", exps_root=tdir,
                                       engine=tengine)
    finally:
        mp.undo()
    return (os.path.join(jdir, "exps_mvs", "scan106"),
            os.path.join(tdir, "exps_mvs", "scan106"), res)


@pytest.mark.parametrize("view", VIEWS)
def test_depth_pfm_matches_jax(both_runs, view):
    jdir, tdir, _ = both_runs
    want, _ = read_pfm(os.path.join(jdir, f"depth_est/{view:08d}.pfm"))
    got, _ = read_pfm(os.path.join(tdir, f"depth_est/{view:08d}.pfm"))
    assert got.shape == want.shape == RES
    np.testing.assert_allclose(got, want, rtol=DEPTH_RTOL)
    rel = np.abs(got - want) / np.abs(want)
    assert np.mean(rel > DEPTH_BAR) <= 0.01, np.mean(rel > DEPTH_BAR)


@pytest.mark.parametrize("view", VIEWS)
def test_confidence_pfm_matches_jax(both_runs, view):
    jdir, tdir, _ = both_runs
    want, _ = read_pfm(os.path.join(jdir, f"confidence/{view:08d}.pfm"))
    got, _ = read_pfm(os.path.join(tdir, f"confidence/{view:08d}.pfm"))
    assert got.shape == want.shape == RES
    close = np.abs(got - want) <= CONF_ATOL
    assert np.mean(~close) <= 1e-3, np.abs(got - want).max()


def _read_floats(path):
    with open(path) as f:
        return np.array([float(x) for x in f.read().split()
                         if x not in ("extrinsic", "intrinsic")])


@pytest.mark.parametrize("view", VIEWS)
def test_cam_file_matches_jax(both_runs, view):
    jdir, tdir, _ = both_runs
    name = f"cams/{view:08d}_cam.txt"
    np.testing.assert_allclose(_read_floats(os.path.join(tdir, name)),
                               _read_floats(os.path.join(jdir, name)),
                               rtol=1e-5, atol=1e-5)


def test_stage_records(both_runs):
    """Three stages timed, one feedback render per training view, and
    the cascade's volumes left as tensors with depth along axis 0."""
    _, _, res = both_runs
    assert len(res["stage_seconds"]) == 3
    assert len(res["feedback_seconds"]) == 3
    for k, D in (("stage1", 16), ("stage2", 8), ("stage3", 8)):
        pv = res["outs"][0][k]["prob_volume"]
        assert pv.shape[0] == D
        np.testing.assert_allclose(pv.sum(0).numpy(), 1.0, atol=1e-4)


@pytest.mark.parametrize("name", ["ucsnet", "transmvsnet"])
def test_engine_refuses_other_cascades(name):
    cfg = shrink(tconfig.dtu_config())
    cfg.mvs.model_name = name
    with pytest.raises(NotImplementedError, match=name):
        trunner.MVSEngine(cfg, device="cpu")


def test_save_scene_depth_takes_one_device():
    """The trainer runs on the engine's device: an engine and a device
    together are refused rather than left to disagree."""
    cfg = shrink(tconfig.dtu_config())
    engine = trunner.MVSEngine(cfg, device="cpu")
    with pytest.raises(ValueError, match="not both"):
        trunner.save_scene_depth(cfg, "scan106", engine=engine, device="cpu")


def test_save_scene_depth_defaults_to_cuda(monkeypatch):
    """Given neither an engine nor a device, the scene runs on "cuda";
    with no CUDA device that is an error naming CUDA, not a silent CPU
    run."""
    cfg = shrink(tconfig.dtu_config())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.save_scene_depth(cfg, "scan106")


def test_save_depth_defaults_to_cuda(monkeypatch):
    """The scene-list entry point, like the single scene's, runs on
    "cuda" unless told otherwise, and without a card raises naming CUDA."""
    cfg = shrink(tconfig.dtu_config())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trunner.save_depth(cfg, ["scan106"])


@pytest.mark.parametrize("view", VIEWS)
def test_output_pngs(both_runs, view):
    """The visualisations hold the JAX function's BGR pixels of the
    port's own PFMs, stored as cv2.imwrite stores them; the image copy is
    the sample's exact 8-bit pixels, within JPEG error of the JAX
    package's copy."""
    import cv2
    from s_volsdf_tpu.utils.viz import visualize_depth as jviz
    jdir, tdir, res = both_runs
    sample = next(s for s in res["samples"] if s.view_ids[0] == view)
    depth, _ = read_pfm(os.path.join(tdir, f"depth_est/{view:08d}.pfm"))
    conf, _ = read_pfm(os.path.join(tdir, f"confidence/{view:08d}.pfm"))
    want = jviz(depth, depth_min=float(np.quantile(depth, 0.01)),
                depth_max=float(np.max(sample.depth_values)))
    got = cv2.imread(os.path.join(tdir, f"depth_est/{view:08d}.png"))
    np.testing.assert_array_equal(got, want)
    got = cv2.imread(os.path.join(tdir, f"confidence/{view:08d}_final.png"),
                     cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, jviz(conf, direct=True))
    img = read_png(os.path.join(tdir, f"images/{view:08d}.png"))
    np.testing.assert_array_equal(
        img, (np.clip(sample.imgs[0], 0, 1) * 255).astype(np.uint8))
    jpg = cv2.imread(os.path.join(jdir, f"images/{view:08d}.jpg"))[..., ::-1]
    assert np.abs(img.astype(int) - jpg).mean() < 2.0


def test_port_trains_and_feeds_back(data_root, tmp_path):
    """The port alone, three steps at stage 0: finite losses; depths in
    the DTU-scaled metric range of the fixture (world_scale 200); the
    trainer's run directory under exps_root with the checkpoints
    "latest" and "epoch_1" at iter_step 3."""
    cfg = _configure(tconfig.dtu_config(), data_root, (3, 0, 0))
    launches = fused_sdf.fused_sdf_values.launches
    res = trunner.save_scene_depth(cfg, "scan106", exps_root=str(tmp_path),
                                   device="cpu")
    losses = [lo.loss for lo in res["trainer"].losses]
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    ckpts = res["trainer"].checkpoints_path
    assert os.path.dirname(os.path.dirname(ckpts)) == os.path.join(
        str(tmp_path), cfg.exps_folder, "ours_106")
    assert sorted(os.listdir(ckpts)) == ["epoch_1", "latest"]
    with np.load(os.path.join(ckpts, "latest", "state.npz")) as st:
        n = sum(k.startswith("leaf_") for k in st.files)
        assert int(st[f"leaf_{n - 1}"]) == 3        # iter_step
    for view in VIEWS:
        depth, _ = read_pfm(os.path.join(
            str(tmp_path), "exps_mvs", "scan106", f"depth_est/{view:08d}.pfm"))
        assert np.isfinite(depth).all()
        assert depth.min() > 100 and depth.max() < 1500, \
            (depth.min(), depth.max())
    # On the CPU the renders take the plain SDF version.
    assert fused_sdf.fused_sdf_values.launches == launches
