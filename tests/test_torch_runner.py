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

The UCSNet and TransMVSNet runs are in tests/test_torch_runner_cascades.py
(their helpers stay here: the other cascade tests import them).
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
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset
from s_volsdf_tpu_torch.data.splits import get_trains_ids
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import lively_mvs_tree, params_pair, shrink

RES = (64, 96)
VIEWS = (25, 22, 28)
DEPTH_RTOL = 1e-3       # every pixel
DEPTH_BAR = 1e-4        # at least 99% of the pixels
CONF_ATOL = 1e-5
OTHER_MODELS = ("ucsnet", "transmvsnet")
MVS_TOL = 1e-5          # MVS volumes (README "Verified parity")


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


# --------------------------------------------------------------------------
# UCSNet and TransMVSNet
# --------------------------------------------------------------------------

def lively_checkpoint(data_root, model, path):
    """The JAX engine's random `model` weights made lively, saved as a
    converted checkpoint that both engines load."""
    jcfg = _configure(jconfig.dtu_config(), data_root, (0, 0, 0))
    jcfg.mvs.model_name = model
    params = jax.tree.map(np.asarray, jrunner.MVSEngine(jcfg).params)
    jckpt.save_state(path, lively_mvs_tree(params, np.random.default_rng(0)),
                     model=model)
    return path


def engines(data_root, model, ck, compute_dtype="float32"):
    """(JAX MVSEngine, port MVSEngine) of `model` at `compute_dtype`, one
    device, serial over views, weights from `ck`."""
    cfgs = []
    for mod in (jconfig, tconfig):
        cfg = _configure(mod.dtu_config(), data_root, (0, 0, 0))
        cfg.mvs.model_name = model
        cfg.mvs.compute_dtype = compute_dtype
        cfgs.append(cfg)
    cfgs[0].parallel.shard_rays = cfgs[0].parallel.shard_eval = False
    cfgs[0].parallel.shard_mvs_views = False
    return (jrunner.MVSEngine(cfgs[0], weights_path=ck),
            trunner.MVSEngine(cfgs[1], weights_path=ck, device="cpu"))


def first_sample(data_root):
    return MVSDataset(
        datapath=os.path.join(data_root, "DTU", "mvs_data"), scan="scan106",
        nviews=3, data_dir="DTU", ndepths=16, interval_scale=1.06,
        max_h=RES[0], max_w=RES[1],
        trains_i=get_trains_ids("DTU", "scan106", 3), data_dir_root=data_root,
        x2_mvsres=False)[0]


def stage_pair(jeng, teng, s, stage, prev_depth=None, extra=None):
    """One stage of the first sample on both engines from the same
    inputs: (JAX outputs, JAX extra, port outputs, port extra), numpy."""
    import jax.numpy as jnp
    proj = s.proj_matrices[f"stage{stage + 1}"]
    jf = jeng.sample_features(jeng.scene_feature_cache(jnp.asarray(s.imgs)),
                              [0, 1, 2])
    want, jextra = jeng.stage(
        stage, jf, jnp.asarray(proj), jnp.asarray(s.depth_values),
        None if prev_depth is None else jnp.asarray(prev_depth),
        None if extra is None else jnp.asarray(extra), RES,
        inverse_depth=False)
    tf = teng.sample_features(teng.scene_feature_cache(s.imgs), [0, 1, 2])
    got, textra = teng.stage(
        stage, tf, proj, s.depth_values, prev_depth,
        None if extra is None else torch.tensor(extra), RES,
        inverse_depth=False)
    return ({k: np.asarray(v) for k, v in want.items()}, np.asarray(jextra),
            {k: v.numpy() for k, v in got.items()}, textra.numpy())


def f32_of_bf16_operands(monkeypatch):
    """Make the port's bf16 convs f32 convs of the same bf16-rounded
    operands: the rounding of their output to bf16 (the one place where
    the port's bf16 conv differs from JAX's, ROADMAP queue 3) taken
    away."""
    from s_volsdf_tpu_torch.models.mvs import blocks as B
    in_weight_dtype = B._in_weight_dtype

    def unrounded(conv, x, apply):
        w = conv.weight.data
        if w.dtype != torch.bfloat16:
            return in_weight_dtype(conv, x, apply)
        conv.weight.data = w.float()
        try:
            return in_weight_dtype(conv, x.to(torch.bfloat16).float(), apply)
        finally:
            conv.weight.data = w
    monkeypatch.setattr(B, "_in_weight_dtype", unrounded)


def sure_pixels(prob, tol=MVS_TOL):
    """Pixels whose top two probabilities differ by more than tol: there
    winner-take-all picks the same hypothesis on either side."""
    top2 = -np.sort(-prob, axis=0)[:2]
    return top2[0] - top2[1] > tol


def assert_stage_matches(got, want, model, prob_tol=MVS_TOL,
                         depth_rtol=MVS_TOL):
    """prob_volume within prob_tol and the hypotheses within 1e-5
    relative; the depth within depth_rtol relative (UCSNet's
    regression), or TransMVSNet's winner-take-all hypothesis equal on the
    `sure_pixels` (at least half of them) and its confidence within
    prob_tol everywhere."""
    np.testing.assert_allclose(got["depth_values"], want["depth_values"],
                               rtol=1e-5)
    assert np.abs(got["prob_volume"] - want["prob_volume"]).max() <= prob_tol
    if model == "transmvsnet":
        sure = sure_pixels(want["prob_volume"], prob_tol)
        assert sure.mean() >= 0.5, sure.mean()
        np.testing.assert_array_equal(got["prob_volume"].argmax(0)[sure],
                                      want["prob_volume"].argmax(0)[sure])
        np.testing.assert_allclose(got["depth"][sure], want["depth"][sure],
                                   rtol=1e-6)
        assert np.abs(got["photometric_confidence"]
                      - want["photometric_confidence"]).max() <= prob_tol
    else:
        np.testing.assert_allclose(got["depth"], want["depth"],
                                   rtol=depth_rtol)
