"""The port's command line (cli/run.py) and config loader against the JAX
package's, and the whole entry point on the CPU.

- `load_config` with overrides: every field the port has equal to the
  JAX loader's, for each preset.
- Both packages' CLIs with filter_only=true on one output directory
  (the port reads the PNG image copies, the JAX package the JPEGs
  beside them, which hold the same pixels): equal point counts, xyz
  within one float32 ulp, rgb equal.
- `main([...], device="cpu")` end to end on a 64x96 fixture at the small
  VolSDF size (tests/test_torch_config.shrink): the PFMs, their PNGs,
  the image copies and a PLY whose points equal `fuse_views` of those
  files; and with the sphere's own depths in place of the estimates,
  the same cameras fuse a cloud on the sphere: median distance to it
  below 0.1, all within fusion's 1% depth gate
  (chip_smoke.sphere_depth, which the smoke run scores the same way).
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from s_volsdf_tpu import config as jconfig  # noqa: E402
from s_volsdf_tpu.cli import run as jrun  # noqa: E402
from s_volsdf_tpu_torch import config as tconfig  # noqa: E402
from s_volsdf_tpu_torch.cli import run as trun  # noqa: E402
from s_volsdf_tpu_torch.data import io as tio  # noqa: E402
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture  # noqa: E402
from s_volsdf_tpu_torch.engine import fusion as tfusion  # noqa: E402
from s_volsdf_tpu_torch.ops import fused_sdf  # noqa: E402
from test_torch_config import _port_fields  # noqa: E402
from test_torch_fusion import (VIEWS, _assert_clouds_match,  # noqa: E402
                               _sphere_views, write_scene_outputs)

OVERRIDES = ["opt_stepNs=[20,0,0]", "use_nerf_d=[1,0,0]", "filter_only=true",
             "num_worker=2", "outdir=runs/x", "testlist=scan24,scan37",
             "mvs.ndepths=[48,32,8]", "mvs.numdepth=48",
             "mvs.depth_inter_r=[1.0,0.5,0.5]", "dataset.img_res=[64,96]",
             "max_h=64", "max_w=96", "loss.confi=0.002",
             "train.learning_rate=0.001", "model.implicit.dims=[64,64]",
             "model.implicit.skip_in=[]", "filter.conf=0.1",
             "filter.eval_mask=false", "model.sampler.N_samples=32",
             "train.train_compute_dtype=float32", "mvs.x2_mvsres=false",
             "inverse_depth=true", "+seed=3", "model.bg_color=[0,0,0]"]

# The small size of tests/test_torch_config.shrink, as command-line
# overrides, at the JAX package's default precision (no precision
# override: the command line runs the bf16 defaults).
SMALL = ["model.implicit.dims=[32,32,32,32]", "model.implicit.skip_in=[2]",
         "model.implicit.multires=4", "model.rendering.dims=[32,32]",
         "model.feature_vector_size=32", "model.sampler.N_samples_eval=24",
         "model.sampler.N_samples=16", "model.sampler.N_samples_extra=4",
         "train.num_pixels=16"]


@pytest.mark.parametrize("preset", ["dtu", "bmvs", "default"])
def test_load_config_matches_jax(preset):
    overrides = [o.lstrip("+") for o in OVERRIDES]
    t = tconfig.load_config(preset, overrides=overrides)
    j = jconfig.load_config(preset, overrides=overrides)
    pairs = list(_port_fields(t, j))
    assert len(pairs) > 50
    diff = [(p, a, b) for p, a, b in pairs
            if a != b or type(a) is not type(b)]
    assert not diff, diff


def test_bmvs_preset_refused_when_run():
    """The bmvs preset's background model and inverse-sphere sampler run
    since they were ported: `check_ported` accepts the preset, and gate
    rescue; only the orbax backend is still refused."""
    cfg = tconfig.load_config("bmvs", overrides=SMALL)
    assert cfg.model.with_background and cfg.model.sampler.inverse_sphere_bg
    tconfig.check_ported(cfg)
    cfg.loss.gate_rescue = True
    tconfig.check_ported(cfg)
    cfg.train.ckpt_backend = "orbax"
    with pytest.raises(NotImplementedError, match="orbax"):
        tconfig.check_ported(cfg)


@pytest.mark.parametrize("key", ["parallel.mesh_size=[2]",
                                 "parallel.shard_ray=false",
                                 "parallel.axes=[rays]",
                                 "sharding.shard_eval=false",
                                 "train.shard_mvs_views=true"])
def test_unknown_override_raises(key):
    """A key or section the port lacks raises, naming it; it is never
    dropped. (The parallel section itself is ported:
    tests/test_torch_parallel.py parses its keys.)"""
    name = key.partition("=")[0]
    with pytest.raises(ValueError, match=name.split(".")[0]):
        tconfig.load_config("dtu", overrides=[key])


def test_parse_testlist_matches_jax(tmp_path):
    path = tmp_path / "scans.txt"
    path.write_text("scan24\n\nscan37\nscan106\n")
    for arg in ("scan24, scan37,scan106", "scan106", str(path)):
        assert trun.parse_testlist(arg) == jrun.parse_testlist(arg)


@pytest.fixture
def scan_outputs(tmp_path):
    """<out>/scan106 with the runner's outputs for the training views and
    DTU eval masks for them under <data>/DTU/eval_mask/scan106."""
    out, data = tmp_path / "out", tmp_path / "data"
    _, views = _sphere_views()
    scan_dir = str(out / "scan106")
    mask_dir = write_scene_outputs(scan_dir, views, mask_res=(60, 80))
    shutil.move(mask_dir, str(data / "DTU" / "eval_mask" / "scan106"))
    return str(out), str(data)


def test_cli_filter_only_matches_jax(scan_outputs):
    out, data = scan_outputs
    argv = [f"outdir={out}", "testlist=scan106", f"data_dir_root={data}",
            "filter_only=true"]
    ply = os.path.join(out, "mvsnet106_l3.ply")
    jrun.main(argv)
    os.replace(ply, ply + ".jax")
    assert trun.main(argv, device="cpu") == [ply]
    _assert_clouds_match(tio.load_ply(ply), tio.load_ply(ply + ".jax"))


def test_cli_defaults_to_cuda(scan_outputs, monkeypatch):
    out, data = scan_outputs
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        trun.main([f"outdir={out}", "testlist=scan106",
                   f"data_dir_root={data}", "filter_only=true"])


@pytest.mark.parametrize("arg,item", [("multiscene=true", "Multi-scene")])
def test_unported_modes_raise(arg, item, tmp_path, monkeypatch):
    """The modes the port once refused with NotImplementedError naming
    their ROADMAP item. `item` (queue 1's multi-scene training) is
    ported now: the mode runs save_depth_multiscene, which here stops at
    the scenes' absent data, and nothing refuses it."""
    reached = []
    joint = trun.save_depth_multiscene

    def spy(*a, **k):
        reached.append(a[1])
        return joint(*a, **k)
    monkeypatch.setattr(trun, "save_depth_multiscene", spy)
    with pytest.raises(FileNotFoundError, match="scan24"):
        trun.main([arg, "testlist=scan24,scan37", f"outdir={tmp_path}"],
                  device="cpu")
    assert reached == [["scan24", "scan37"]]


@pytest.mark.parametrize("model", tconfig.MVS_MODELS)
def test_mvs_model_name_reaches_the_engine(model, tmp_path, monkeypatch):
    """`mvs.model_name=` builds that cascade: the engine that save_depth
    makes from the command line's config."""
    from s_volsdf_tpu_torch.engine import runner as trunner
    built = []

    def save_depth(cfg, testlist, *, mvs_weights=None, device=None):
        built.append(trunner.MVSEngine(cfg, device=device))
    monkeypatch.setattr(trun, "save_depth", save_depth)
    monkeypatch.setattr(trun, "pcd_filter", lambda *a, **k: [])
    trun.main([f"mvs.model_name={model}", "testlist=scan106",
               f"outdir={tmp_path}"], device="cpu")
    assert built[0].name == model
    assert type(built[0].net).__name__.lower() == model


def test_conflicting_preset_exits():
    with pytest.raises(SystemExit, match="conflicting"):
        trun.main(["preset=dtu", "vol=bmvs"], device="cpu")


def test_cli_end_to_end_cpu(tmp_path):
    """The port's entry point from the cascade to the fused PLY on a
    64x96 fixture: opt_stepNs (1, 0, 0) hands stage 0's volumes to the
    trainer, renders the feedback depth without a step, then fuses. The
    trainer's run directory, <exps_folder>/ours_106/<timestamp>, holds
    the run's config as run.yaml (JSON), plots/ and checkpoints/, which
    stays empty: no step, no checkpoint (as in the JAX package)."""
    data = str(tmp_path / "data")
    make_dtu_fixture(data, scan_id=106, img_res=(64, 96))
    out = str(tmp_path / "exps")
    vsdf = str(tmp_path / "vsdf")
    launches = fused_sdf.fused_sdf_values.launches
    plys = trun.main(["testlist=scan106", f"outdir={out}",
                      f"exps_folder={vsdf}",
                      f"data_dir_root={data}", f"dataset.data_dir_root={data}",
                      "max_h=64", "max_w=96", "dataset.img_res=[64,96]",
                      "mvs.ndepths=[16,8,8]", "mvs.numdepth=16",
                      "mvs.x2_mvsres=false", "opt_stepNs=[1,0,0]"] + SMALL,
                     device="cpu")
    assert fused_sdf.fused_sdf_values.launches == launches
    (stamp,) = os.listdir(os.path.join(vsdf, "ours_106"))
    run = os.path.join(vsdf, "ours_106", stamp)
    assert sorted(os.listdir(run)) == ["checkpoints", "plots", "run.yaml"]
    assert os.listdir(os.path.join(run, "checkpoints")) == []
    with open(os.path.join(run, "run.yaml")) as f:
        snap = json.load(f)
    assert snap["exps_folder"] == vsdf and snap["opt_stepNs"] == [1, 0, 0]
    scan_dir = os.path.join(out, "scan106")
    for v in VIEWS:
        for name in (f"depth_est/{v:08d}.pfm", f"confidence/{v:08d}.pfm",
                     f"depth_est/{v:08d}.png", f"confidence/{v:08d}_final.png",
                     f"images/{v:08d}.png", f"cams/{v:08d}_cam.txt"):
            assert os.path.isfile(os.path.join(scan_dir, name)), name
        assert tio.read_png(os.path.join(scan_dir, f"depth_est/{v:08d}.png")
                            ).shape == (64, 96, 3)
    assert plys == [os.path.join(out, "mvsnet106_l3.ply")]
    views, masks = tfusion.load_views(scan_dir, scan_dir, VIEWS, device="cpu")
    xyz, rgb, _ = tfusion.fuse_views(views, eval_masks=masks, device="cpu")
    got_xyz, got_rgb = tio.load_ply(plys[0])
    np.testing.assert_array_equal(got_xyz, xyz)
    np.testing.assert_array_equal(got_rgb, rgb)
    assert np.isfinite(got_xyz).all()
    for view in views:
        view["depth"] = chip_smoke.sphere_depth(
            view["intrinsics"], view["extrinsics"], view["depth"].shape)
    txyz, _, _ = tfusion.fuse_views(views, device="cpu")
    off = np.abs(np.linalg.norm(txyz, axis=1) - chip_smoke.SPHERE_RADIUS)
    # Near the silhouette the averaged depth may mix in a bilinear sample
    # across the edge, up to fusion's 1% relative depth gate (~6 here).
    assert txyz.shape[0] > 1000 and np.median(off) < 0.1 and off.max() < 6.0
