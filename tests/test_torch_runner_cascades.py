"""UCSNet and TransMVSNet (the engine's two other cascades) through the
scene runner, with the JAX engine's random weights made lively
(`test_torch_config.lively_mvs_tree`: random BN, He's gain, random DCN
offset convs), loaded by both engines from one converted checkpoint, on
tests/test_torch_runner.py's 64x96 DTU fixture and helpers:
- both packages' `save_scene_depth` with ablate=true (the cascade alone,
  the extras threaded from stage to stage), PFMs compared. UCSNet's
  regressed depth within 1e-5 relative (the MVS volumes' bar) and its
  confidence as CasMVSNet's; TransMVSNet's winner-take-all depth equal
  (1e-6 relative: the two packages' hypotheses) on every pixel whose
  top two stage-3 probabilities differ by more than 1e-5 (elsewhere
  argmax may pick either), its confidence within 1e-5 on the pixels
  whose three stages all pass that rule;
- one stage 1 with an injected full-resolution previous depth (as a
  feedback render gives it) and extra, against JAX's: prob within 1e-5,
  depth as above;
- the port alone with a 2-step VolSDF budget at stage 0: stages 1 and 2
  receive the feedback render and the previous stage's extra.
"""

import os

import numpy as np
import pytest
import torch

from s_volsdf_tpu.engine import runner as jrunner
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.data.io import read_pfm
from s_volsdf_tpu_torch.engine import runner as trunner
from test_torch_runner import (CONF_ATOL, MVS_TOL, OTHER_MODELS, RES, VIEWS,
                               _configure, assert_stage_matches,
                               data_root,  # noqa: F401 (the shared fixture)
                               engines, first_sample, lively_checkpoint,
                               stage_pair, sure_pixels)


@pytest.fixture(scope="module", params=OTHER_MODELS)
def ablate_runs(request, data_root, tmp_path_factory):
    """Both packages' save_scene_depth of `model` with ablate=true."""
    model = request.param
    out = tmp_path_factory.mktemp(f"ablate_{model}")
    ck = lively_checkpoint(data_root, model, str(out / "ck"))
    jeng, teng = engines(data_root, model, ck)
    jdir, tdir = str(out / "jax"), str(out / "port")
    jeng.cfg.ablate = teng.cfg.ablate = True
    jrunner.save_scene_depth(jeng.cfg, "scan106", exps_root=jdir, engine=jeng)
    res = trunner.save_scene_depth(teng.cfg, "scan106", exps_root=tdir,
                                   engine=teng)
    return (model, os.path.join(jdir, "exps_mvs", "scan106"),
            os.path.join(tdir, "exps_mvs", "scan106"), res)


@pytest.mark.parametrize("view", VIEWS)
def test_ablate_pfms_match_jax(ablate_runs, view):
    model, jdir, tdir, res = ablate_runs
    assert len(res["stage_seconds"]) == 3 and not res["feedback_seconds"]
    pfm = {}
    for kind in ("depth_est", "confidence"):
        want, _ = read_pfm(os.path.join(jdir, f"{kind}/{view:08d}.pfm"))
        got, _ = read_pfm(os.path.join(tdir, f"{kind}/{view:08d}.pfm"))
        assert got.shape == want.shape == RES
        assert np.isfinite(got).all()
        pfm[kind] = got, want
    (depth, jdepth), (conf, jconf) = pfm["depth_est"], pfm["confidence"]
    if model == "ucsnet":
        np.testing.assert_allclose(depth, jdepth, rtol=MVS_TOL)
        assert np.mean(np.abs(conf - jconf) > CONF_ATOL) <= 1e-3
        return
    outs = next(o for o, s in zip(res["outs"], res["samples"])
                if s.view_ids[0] == view)
    sure = sure_pixels(outs["stage3"]["prob_volume"].numpy())
    assert sure.mean() >= 0.5, sure.mean()
    np.testing.assert_allclose(depth[sure], jdepth[sure], rtol=1e-6)
    for k in ("stage1", "stage2"):
        s = sure_pixels(outs[k]["prob_volume"].numpy())
        sure &= torch.nn.functional.interpolate(
            torch.tensor(s, dtype=torch.float32)[None, None], size=RES,
            mode="nearest")[0, 0].numpy() > 0
    np.testing.assert_allclose(conf[sure], jconf[sure], atol=CONF_ATOL)


def _injected(s, model, rng):
    """A smooth full-resolution depth inside the sample's range (as a
    feedback render hands it on) and a stage-0 extra: UCSNet's spread of
    1-8 hypothesis intervals, TransMVSNet's view weights in (0.2, 1)."""
    dv = np.asarray(s.depth_values)
    lo, hi = float(dv[0]), float(dv[-1])
    yy, xx = np.meshgrid(np.linspace(0, 1, RES[0]), np.linspace(0, 1, RES[1]),
                         indexing="ij")
    depth = (lo + (hi - lo) * (0.45 + 0.1 * np.sin(3 * xx + 2 * yy)))
    h4, w4 = RES[0] // 4, RES[1] // 4
    if model == "ucsnet":
        extra = rng.uniform(1, 8, (h4, w4)) * (hi - lo) / dv.shape[0]
    else:
        extra = rng.uniform(0.2, 1.0, (2, h4, w4))
    return depth.astype(np.float32), extra.astype(np.float32)


@pytest.mark.parametrize("model", OTHER_MODELS)
def test_stage_with_injected_feedback_matches_jax(data_root, tmp_path, model):
    ck = lively_checkpoint(data_root, model, str(tmp_path / "ck"))
    jeng, teng = engines(data_root, model, ck)
    s = first_sample(data_root)
    depth, extra = _injected(s, model, np.random.default_rng(3))
    want, jextra, got, textra = stage_pair(jeng, teng, s, 1, depth, extra)
    assert_stage_matches(got, want, model)
    if model == "ucsnet":
        np.testing.assert_allclose(textra, jextra, rtol=MVS_TOL)
    else:
        # The given weights, upsampled 2x, are handed on unchanged.
        np.testing.assert_array_equal(textra, jextra)
        assert textra.shape == (2, RES[0] // 2, RES[1] // 2)


@pytest.mark.parametrize("model", OTHER_MODELS)
def test_port_feedback_and_extras_reach_later_stages(data_root, tmp_path,
                                                     monkeypatch, model):
    """The port alone, two VolSDF steps at stage 0: stage 1 of each view
    is given the view's feedback render and its stage-0 extra, stage 2
    the stage-1 depth and extra; TransMVSNet's FMT runs once a sample."""
    cfg = _configure(tconfig.dtu_config(), data_root, (2, 0, 0))
    cfg.mvs.model_name = model
    engine = trunner.MVSEngine(cfg, device="cpu")
    calls, feedback = [], []
    stage, feedback_depths = engine.stage, trunner.feedback_depths

    def recording(stage_idx, feats, proj, dv, prev_depth, extra, hw, **kw):
        out, new_extra = stage(stage_idx, feats, proj, dv, prev_depth, extra,
                               hw, **kw)
        calls.append((stage_idx, prev_depth, extra, new_extra))
        return out, new_extra

    def recording_feedback(sc, outs):
        feedback_depths(sc, outs)
        feedback.extend(np.array(o["depth"]) for o in outs)
    fmt_calls = []
    fmt = trunner.fmt_with_pathway
    monkeypatch.setattr(engine, "stage", recording)
    monkeypatch.setattr(trunner, "feedback_depths", recording_feedback)
    monkeypatch.setattr(trunner, "fmt_with_pathway",
                        lambda *a: (fmt_calls.append(1), fmt(*a))[1])
    res = trunner.save_scene_depth(cfg, "scan106", exps_root=str(tmp_path),
                                   engine=engine)
    # TransMVSNet's FMT once a sample, not once a stage.
    assert len(fmt_calls) == (3 if model == "transmvsnet" else 0)
    losses = [lo.loss for lo in res["trainer"].losses]
    assert len(losses) == 2 and np.all(np.isfinite(losses))
    assert [c[0] for c in calls] == [0] * 3 + [1] * 3 + [2] * 3
    assert len(feedback) == 3
    for i in range(3):
        s0, s1, s2 = calls[i], calls[3 + i], calls[6 + i]
        assert s0[1] is None and s0[2] is None
        h4, w4 = RES[0] // 4, RES[1] // 4
        assert s0[3].shape == ((h4, w4) if model == "ucsnet" else (2, h4, w4))
        np.testing.assert_array_equal(s1[1], feedback[i])
        assert s1[2] is s0[3] and s2[2] is s1[3]
        np.testing.assert_array_equal(s2[1], res["outs"][i]["stage2"]["depth"])
        assert np.isfinite(res["outs"][i]["depth"]).all()
