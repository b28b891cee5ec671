"""The cascade's precision (`mvs.compute_dtype`) and the whole slice at the
JAX defaults, on the 64x96 DTU fixture of tests/test_torch_runner.py;
and the port's float32 paths held out of TF32.

The cascade's weights are the JAX engine's random ones with every conv
kernel scaled by sqrt(6) (He's gain for the +-sqrt(1/fan_in) uniform
init), so that the features keep their size through the ReLUs and the
stage-0 probabilities are not uniform (with the plain init they are
1/D to the bit, and bf16 or float32 could not be told apart).

Bars:
  * one bf16 stage 0 of MVSEngine against the JAX MVSEngine with
    `cast_conv_weights`: prob within 2e-5, depth within 5e-6 relative.
    The port's bf16 convs round their output to bf16 (cuDNN's on the
    card, the CPU's here), where JAX's preferred_element_type=f32 does
    not: one more rounding of 2^-9 relative per conv. Measured here:
    3.5e-6 (prob) and 5.5e-7 (depth); the port against an f32 conv of
    the same bf16 operands, the output rounding alone, 3.3e-6 and
    5.5e-7 (ROADMAP queue 3).
  * the whole slice (`save_scene_depth` of both packages, the defaults,
    opt_stepNs (1, 0, 0): stage 0's volumes go to the trainer, no step,
    float32 feedback renders): stage 0's regressed depth of every view
    within 5e-6 relative and its confidence within 2e-5; the final
    depth PFMs within 1e-4 relative on at least 99% of the pixels and
    1e-3 on every pixel, the float32 bars of tests/test_torch_runner.py
    (the fed-back render's float32 ill-conditioning, ROADMAP queue 3,
    dominates the bf16 cascade's rounding).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu import config as jconfig
from s_volsdf_tpu.engine import runner as jrunner
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.data.io import read_pfm
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset
from s_volsdf_tpu_torch.data.splits import get_trains_ids
from s_volsdf_tpu_torch.engine import runner as trunner
from s_volsdf_tpu_torch.engine import trainer as ttrainer
from s_volsdf_tpu_torch.models import layers as tlayers
from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import IMG_RES, VOL, params_pair, shrink
from test_torch_runner import RES, VIEWS, _configure, f32_of_bf16_operands

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

PROB_TOL, DEPTH_RTOL = 2e-5, 5e-6


def _defaults(cfg):
    for name in ("train_compute_dtype", "train_activation_dtype",
                 "mvs_pack_dtype"):
        setattr(cfg.train, name, "bfloat16")
    cfg.mvs.compute_dtype = "bfloat16"
    return cfg


def _he_gain(tree):
    if isinstance(tree, list):
        return [_he_gain(t) for t in tree]
    if isinstance(tree, dict):
        return {k: (np.asarray(v) * np.float32(6 ** 0.5)
                    if k == "w" and np.ndim(v) >= 4 else _he_gain(v))
                for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def fixture(tmp_path_factory):
    """(data root, checkpoint of the He-gain cascade weights)."""
    tmp = tmp_path_factory.mktemp("precision")
    root = str(tmp / "data")
    make_dtu_fixture(root, scan_id=106, img_res=RES)
    jcfg = _configure(jconfig.dtu_config(), root, (0, 0, 0))
    params = jrunner.MVSEngine(jcfg, rng_seed=0).params
    ck = str(tmp / "casmvsnet_gain")
    jckpt.save_state(ck, _he_gain(jax.tree.map(np.asarray, params)),
                     model="casmvsnet")
    return root, ck


def _sample(root):
    return MVSDataset(
        datapath=os.path.join(root, "DTU", "mvs_data"), scan="scan106",
        nviews=3, data_dir="DTU", ndepths=16, interval_scale=1.06,
        max_h=RES[0], max_w=RES[1], trains_i=get_trains_ids("DTU", "scan106", 3),
        data_dir_root=root, x2_mvsres=False)[0]


def _port_stage0(engine, s):
    feats = engine.scene_feature_cache(s.imgs)["feats"]
    out, _ = engine.stage(0, feats, s.proj_matrices["stage1"],
                          s.depth_values, None, None, RES,
                          inverse_depth=False)
    return {k: v.numpy() for k, v in out.items()}


def _rel(a, b):
    return float(np.max(np.abs(a - b) / np.abs(b)))


def test_cascade_stage_bf16_matches_jax(fixture, monkeypatch):
    root, ck = fixture
    jcfg = _defaults(_configure(jconfig.dtu_config(), root, (0, 0, 0)))
    tcfg = _defaults(_configure(tconfig.dtu_config(), root, (0, 0, 0)))
    s = _sample(root)
    jeng = jrunner.MVSEngine(jcfg, weights_path=ck, rng_seed=0)
    feats = jeng.scene_feature_cache(jnp.asarray(s.imgs))["feats"]
    want, _ = jeng.stage(0, feats, jnp.asarray(s.proj_matrices["stage1"]),
                         jnp.asarray(s.depth_values), None, None, RES,
                         inverse_depth=False)
    want = {k: np.asarray(v) for k, v in want.items()}
    teng = trunner.MVSEngine(tcfg, weights_path=ck, device="cpu")
    convs = [m for m in teng.net.modules() if isinstance(m, B.Conv3d)]
    assert convs and all(m.weight.dtype == torch.bfloat16 for m in convs)
    got = _port_stage0(teng, s)
    assert np.ptp(want["prob_volume"]) > 1e-4      # not uniform
    assert np.abs(got["prob_volume"] - want["prob_volume"]).max() <= PROB_TOL
    assert _rel(got["depth"], want["depth"]) <= DEPTH_RTOL

    # The output rounding alone: the port against an f32 conv of the same
    # bf16 operands.
    f32_of_bf16_operands(monkeypatch)
    unrounded = _port_stage0(teng, s)
    assert np.abs(got["prob_volume"]
                  - unrounded["prob_volume"]).max() <= PROB_TOL
    assert _rel(got["depth"], unrounded["depth"]) <= DEPTH_RTOL
    assert not np.array_equal(got["prob_volume"], unrounded["prob_volume"])


def test_mvs_compute_dtype_is_live(fixture):
    """mvs.compute_dtype alone, float32 -> bfloat16, changes stage 0."""
    root, ck = fixture
    s = _sample(root)
    outs = []
    for dtype in ("float32", "bfloat16"):
        cfg = _configure(tconfig.dtu_config(), root, (0, 0, 0))
        cfg.mvs.compute_dtype = dtype
        outs.append(_port_stage0(
            trunner.MVSEngine(cfg, weights_path=ck, device="cpu"), s))
    assert not np.array_equal(outs[0]["prob_volume"], outs[1]["prob_volume"])
    assert np.isfinite(outs[1]["prob_volume"]).all()


def _record_flags(calls):
    def record(*_, **__):
        calls.append((torch.backends.cudnn.allow_tf32,
                      torch.backends.cuda.matmul.allow_tf32))
    return record


@pytest.mark.parametrize("path", ["cascade", "step", "render"])
def test_float32_paths_keep_tf32_off(fixture, monkeypatch, path):
    """While the cascade's convs, the training step's and the render's
    layers run, cuDNN's and cuBLAS's TF32 flags are off; outside they are
    as they were (cuDNN's default is on). The flags are global state,
    read here on the CPU; on the card they switch float32 convs and
    products to TF32."""
    root, ck = fixture
    defaults = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    assert defaults[0]     # cuDNN's TF32 is on by default
    torch.backends.cuda.matmul.allow_tf32 = True
    calls = []
    record = _record_flags(calls)
    try:
        if path == "cascade":
            cfg = _configure(tconfig.dtu_config(), root, (0, 0, 0))
            engine = trunner.MVSEngine(cfg, weights_path=ck, device="cpu")
            conv = B.Conv3d.forward
            monkeypatch.setattr(B.Conv3d, "forward",
                                lambda self, x: (record(), conv(self, x))[1])
            _port_stage0(engine, _sample(root))
        else:
            cfg = shrink(chip_smoke.float32_dtu_config())
            trainer = chip_smoke.make_trainer(cfg, IMG_RES, VOL, "cpu")
            # The step's MLP layers; the render's SDF sweeps (on the CPU
            # the fused kernel's plain version).
            module, name = ((tlayers, "apply_linear") if path == "step"
                            else (fused_sdf, "sdf_values_plain"))
            fn = getattr(module, name)
            monkeypatch.setattr(module, name,
                                lambda *a: (record(), fn(*a))[1])
            if path == "step":
                trainer.run(1)
            else:
                trainer.render_mvs(0, res_scale=0.25, chunk=64)
        assert calls and all(c == (False, False) for c in calls), calls[:3]
        assert (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32) == (defaults[0], True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = defaults[1]


@pytest.fixture(scope="module")
def both_runs(fixture, tmp_path_factory):
    """Both packages' save_scene_depth at the JAX defaults, with the JAX
    stage-0 outputs recorded before the feedback render overwrites
    their depth."""
    root, ck = fixture
    out = tmp_path_factory.mktemp("default_runs")
    jcfg = _defaults(_configure(jconfig.dtu_config(), root, (1, 0, 0)))
    jcfg.parallel.shard_rays = jcfg.parallel.shard_eval = False
    jcfg.parallel.shard_mvs_views = False
    tcfg = _defaults(_configure(tconfig.dtu_config(), root, (1, 0, 0)))
    assert (tcfg.train.train_compute_dtype, tcfg.mvs.compute_dtype,
            tcfg.train.feedback_render_dtype) == ("bfloat16", "bfloat16",
                                                  "float32")
    jengine = jrunner.MVSEngine(jcfg, weights_path=ck, rng_seed=0)
    tengine = trunner.MVSEngine(tcfg, weights_path=ck, device="cpu")
    mp = pytest.MonkeyPatch()
    jstage0 = []
    run_stage = jrunner.run_mvs_stage

    def recording(cfg, engine, sc, stage_idx):
        outs, extras = run_stage(cfg, engine, sc, stage_idx)
        if stage_idx == 0:
            jstage0.extend({k: np.array(v) for k, v in o.items()}
                           for o in outs)
        return outs, extras
    mp.setattr(jrunner, "run_mvs_stage", recording)
    _, tparams = params_pair(jcfg, seed=jcfg.seed)
    mp.setattr(ttrainer, "init_volsdf_params",
               lambda gen, mcfg, device: tparams.to(device))
    jdir, tdir = str(out / "jax"), str(out / "port")
    try:
        jrunner.save_scene_depth(jcfg, "scan106", exps_root=jdir,
                                 engine=jengine)
        res = trunner.save_scene_depth(tcfg, "scan106", exps_root=tdir,
                                       engine=tengine)
    finally:
        mp.undo()
    return (os.path.join(jdir, "exps_mvs", "scan106"),
            os.path.join(tdir, "exps_mvs", "scan106"), res, jstage0)


def test_stage0_at_defaults_matches_jax(both_runs):
    _, _, res, jstage0 = both_runs
    assert len(jstage0) == len(res["outs"]) == 3
    for want, out in zip(jstage0, res["outs"]):
        got = out["stage1"]
        depth = (got["prob_volume"] * got["depth_values"]).sum(0).numpy()
        assert _rel(depth, want["depth"]) <= DEPTH_RTOL
        np.testing.assert_allclose(got["photometric_confidence"],
                                   want["photometric_confidence"],
                                   atol=PROB_TOL)


@pytest.mark.parametrize("view", VIEWS)
def test_depth_pfm_at_defaults_matches_jax(both_runs, view):
    jdir, tdir, _, _ = both_runs
    want, _ = read_pfm(os.path.join(jdir, f"depth_est/{view:08d}.pfm"))
    got, _ = read_pfm(os.path.join(tdir, f"depth_est/{view:08d}.pfm"))
    assert got.shape == want.shape == RES
    np.testing.assert_allclose(got, want, rtol=1e-3)
    rel = np.abs(got - want) / np.abs(want)
    assert np.mean(rel > 1e-4) <= 0.01, np.mean(rel > 1e-4)
