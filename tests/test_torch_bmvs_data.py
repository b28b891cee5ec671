"""The BlendedMVS data path, checkpoints and evaluation of the port
against the JAX package's.

- The BMVS fixture (`make_bmvs_fixture`): the same cameras.npz, cam txt
  files, pair.txt and image pixels as the JAX package's.
- `load_scene` on it: rgb bit-equal, rgb_smooth within the blur gap
  (1e-5, tests/test_torch_data.py), cameras 1e-5, the masks (an RGBA
  mask the test adds for an eval and a training view: its alpha,
  nearest-resized, > 0.5) equal, `near_pose` within 1e-5 (a camera).
- `MVSDataset` samples for scan1 and for the scan4 and scan5 layouts
  (their depth-max cap at 2.197 x depth_min, scan5's scale): depth
  hypotheses and near/far equal, projections 1e-5, images 1e-5.
- Checkpoints of the background model: a port TrainState (two steps)
  loads in JAX `load_state`, a JAX one (random leaves) in the port, leaf
  for leaf in the order bg_rgb, bg_sdf, density, rgb, sdf; a resume is
  bit-equal.
- The renders and mesh export of a background model: `render_depth`
  (unclamped, the sphere's exit dropped) and `render_image` (the near
  pose's directions) within 2e-4 of JAX's; `export_mesh` sweeps
  unclamped and, on the JAX SDF values, writes JAX's mesh.
- `save_bmvs_gt` on an OBJ the test writes: the same points as JAX's;
  `cli.eval_bmvs` the JAX protocol's Chamfer; `cli.eval_vsdf --conf bmvs`
  end to end on the CPU at 64x96.
"""

import os

import imageio.v2 as imageio
import jax
import numpy as np
import pytest
import torch

import chip_smoke
from s_volsdf_tpu.data import fixtures as jfix
from s_volsdf_tpu.data.mvs_dataset import MVSDataset as JMVSDataset
from s_volsdf_tpu.data.scene_dataset import load_scene as jload_scene
from s_volsdf_tpu.engine import eval_geo as jgeo
from s_volsdf_tpu.engine import eval_nvs as jnvs
from s_volsdf_tpu.engine import mesh as jmesh
from s_volsdf_tpu.engine import render as jrender
from s_volsdf_tpu.engine.train_step import (init_train_state,
                                            make_optimizer as jmake_optimizer)
from s_volsdf_tpu.models.network import sdf_values as jsdf_values
from s_volsdf_tpu.models.network_bg import init_volsdf_bg_params as jinit_bg
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.cli import eval_bmvs as tcli_bmvs
from s_volsdf_tpu_torch.cli import eval_vsdf as tcli_vsdf
from s_volsdf_tpu_torch.data import fixtures as tfix
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset as TMVSDataset
from s_volsdf_tpu_torch.data.scene_dataset import load_scene as tload_scene
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
from s_volsdf_tpu_torch.data.splits import scan2hash
from s_volsdf_tpu_torch.engine import eval_geo as tgeo
from s_volsdf_tpu_torch.engine import eval_nvs as tnvs
from s_volsdf_tpu_torch.engine import render as trender
from s_volsdf_tpu_torch.engine import trainer as ttrainer
from s_volsdf_tpu_torch.models.network_bg import VolSDFBGParams
from s_volsdf_tpu_torch.utils import checkpoint as tckpt
from test_torch_checkpoint import _jax_names, _port_names
from test_torch_config import (IMG_RES, VOL, bg_params_pair,
                               small_bmvs_configs)

RES = (64, 96)
IMG_TOL = 1e-5
TRAIN_IDS = [9, 10, 55]     # scan1's


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rgba_mask(path, seed):
    """An RGBA mask whose alpha holds a random disc."""
    H, W = RES
    yy, xx = np.mgrid[0:H, 0:W]
    rng = np.random.default_rng(seed)
    cy, cx = rng.uniform(0.3, 0.7) * H, rng.uniform(0.3, 0.7) * W
    alpha = (((yy - cy) ** 2 + (xx - cx) ** 2) < (0.3 * H) ** 2) * 255
    rgba = np.concatenate([np.full((H, W, 3), 128), alpha[..., None]], -1)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tio.write_png(path, rgba.astype(np.uint8))


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The scan1 BMVS fixture written by each package, and RGBA masks for
    eval view 19 and training view 9 in the JAX one; the scan4 and scan5
    layouts written by the port."""
    root = tmp_path_factory.mktemp("bmvs")
    troot, jroot = str(root / "port"), str(root / "jax")
    tfix.make_bmvs_fixture(troot, scan_id=1, img_res=RES)
    jfix.make_bmvs_fixture(jroot, scan_id=1, img_res=RES)
    for vid in (19, 9):
        _rgba_mask(os.path.join(jroot, "BlendedMVS", "eval_mask", "scan1",
                                "mask", f"{vid:08d}.png"), vid)
    for scan_id in (4, 5):
        tfix.make_bmvs_fixture(troot, scan_id=scan_id, img_res=RES)
    return troot, jroot


def test_bmvs_fixture_equal(fixtures):
    troot, jroot = fixtures
    rel = os.path.join("BlendedMVS", "scan1")
    ta = np.load(os.path.join(troot, rel, "cameras.npz"))
    ja = np.load(os.path.join(jroot, rel, "cameras.npz"))
    assert sorted(ta.files) == sorted(ja.files)
    for k in ja.files:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    names = sorted(os.listdir(os.path.join(jroot, rel, "image")))
    assert sorted(os.listdir(os.path.join(troot, rel, "image"))) == names
    for n in names[::9] + [f"{t:06d}.png" for t in TRAIN_IDS]:
        np.testing.assert_array_equal(
            tio.read_png(os.path.join(troot, rel, "image", n)),
            imageio.imread(os.path.join(jroot, rel, "image", n)))
    cams = os.path.join("BlendedMVS", "mvs_data", scan2hash("scan1"), "cams")
    names = sorted(os.listdir(os.path.join(jroot, cams)))
    assert sorted(os.listdir(os.path.join(troot, cams))) == names
    assert "pair.txt" in names and len(names) == 55 + 16 + 1
    for n in names:
        with open(os.path.join(troot, cams, n)) as a, \
                open(os.path.join(jroot, cams, n)) as b:
            assert a.read() == b.read(), n


def test_load_scene_matches_jax(fixtures):
    _, jroot = fixtures
    t = tload_scene("BlendedMVS", RES, 1, 3, jroot)
    j = jload_scene("BlendedMVS", RES, 1, 3, jroot)
    np.testing.assert_allclose(t.intrinsics, j.intrinsics, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t.poses, j.poses, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.rgb, j.rgb)
    np.testing.assert_allclose(t.rgb_smooth, j.rgb_smooth, atol=IMG_TOL)
    assert t.scale_factor == j.scale_factor
    np.testing.assert_array_equal(t.masks, j.masks)
    for vid in (19, 9):
        assert 0 < t.masks[vid].mean() < 1, vid     # the RGBA alpha
    assert (t.masks[20] == 1).all()
    assert t.trains_ids() == j.trains_ids() == TRAIN_IDS
    assert t.eval_ids() == j.eval_ids()
    for vid in t.eval_ids() + TRAIN_IDS:
        np.testing.assert_allclose(t.near_pose(vid), j.near_pose(vid),
                                   rtol=1e-5, atol=1e-5)
    assert not np.array_equal(t.near_pose(19), t.poses[19])


def test_bmvs_mask_must_be_rgba(fixtures, tmp_path):
    _, jroot = fixtures
    import shutil
    root = str(tmp_path / "copy")
    shutil.copytree(os.path.join(jroot, "BlendedMVS", "scan1"),
                    os.path.join(root, "BlendedMVS", "scan1"))
    tio.write_png(os.path.join(root, "BlendedMVS", "eval_mask", "scan1",
                               "mask", "00000019.png"),
                  np.zeros(RES + (3,), np.uint8))
    with pytest.raises(ValueError, match="RGBA"):
        tload_scene("BlendedMVS", RES, 1, 3, root)


@pytest.mark.parametrize("scan", ["scan1", "scan4", "scan5"])
def test_mvs_dataset_matches_jax(fixtures, scan):
    troot, _ = fixtures
    from s_volsdf_tpu_torch.data.splits import get_trains_ids
    trains = get_trains_ids("BlendedMVS", scan, 3)
    kw = dict(datapath=os.path.join(troot, "BlendedMVS", "mvs_data"),
              scan=scan, nviews=3, data_dir="BlendedMVS", ndepths=16,
              interval_scale=1.0, max_h=RES[0], max_w=RES[1],
              trains_i=trains, data_dir_root=troot, x2_mvsres=False)
    tds, jds = TMVSDataset(**kw), JMVSDataset(**kw)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        a, b = tds[i], jds[i]
        assert a.view_ids == b.view_ids and a.filename == b.filename
        np.testing.assert_array_equal(a.depth_values, b.depth_values)
        np.testing.assert_array_equal(a.cam_near_far, b.cam_near_far)
        for k in ("stage1", "stage2", "stage3"):
            np.testing.assert_allclose(a.proj_matrices[k], b.proj_matrices[k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        np.testing.assert_allclose(a.imgs, b.imgs, atol=IMG_TOL)


# --------------------------------------------------------------------------
# Checkpoints of the background model
# --------------------------------------------------------------------------

def _jax_template(jcfg):
    params = jinit_bg(jax.random.PRNGKey(0), jcfg.model)
    return init_train_state(jcfg, params, jmake_optimizer(jcfg))


def _trainer(cfg, exps_root=None, is_continue=False):
    scene = make_sphere_scene(3, IMG_RES)
    trainer = ttrainer.VolTrainer(
        cfg, scene_from_synthetic(scene),
        "scan1" if exps_root else None, device="cpu", exps_root=exps_root,
        is_continue=is_continue, chunk_steps=1)
    trainer.mvs = chip_smoke.make_volumes(scene, VOL, "cpu")
    return trainer


def test_bg_leaf_order_is_jax_flatten_order():
    jcfg, tcfg = small_bmvs_configs()
    tp = ttrainer.init_volsdf_bg_params(torch.Generator().manual_seed(0),
                                        tcfg.model)
    names = _port_names(tp)
    assert names == _jax_names(_jax_template(jcfg))
    assert names[0].startswith("bg_rgb.") and "density.beta" in names


def test_bg_checkpoints_load_both_ways(tmp_path):
    jcfg, tcfg = small_bmvs_configs()
    trainer = _trainer(tcfg, str(tmp_path / "port"))
    assert isinstance(trainer.state.params, VolSDFBGParams)
    trainer.run(2)
    want = tckpt.train_state_leaves(trainer.state)
    state, _ = jckpt.load_state(
        os.path.join(trainer.checkpoints_path, "latest"), _jax_template(jcfg))
    got, _ = jax.tree_util.tree_flatten(state)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)

    leaves, treedef = jax.tree_util.tree_flatten(_jax_template(jcfg))
    rng = np.random.default_rng(3)
    rand = [np.asarray(rng.standard_normal(np.shape(x)), np.float32)
            for x in leaves]
    n = (len(leaves) - 2) // 3
    rand[n], rand[-1] = np.asarray(7, np.int32), np.asarray(11, np.int32)
    rand[2 * n + 1:3 * n + 1] = [np.abs(x) for x in rand[2 * n + 1:3 * n + 1]]
    root = tmp_path / "jax"
    run = root / tcfg.exps_folder / "ours_1" / "t0"
    jckpt.save_state(str(run / "checkpoints" / "latest"),
                     jax.tree_util.tree_unflatten(treedef, rand), epoch=5)
    resumed = _trainer(tcfg, str(root), is_continue=True)
    for g, w in zip(tckpt.train_state_leaves(resumed.state), rand):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert resumed.state.iter_step == 11


def test_bg_resume_continues_bit_for_bit(tmp_path):
    _, tcfg = small_bmvs_configs()
    whole = _trainer(tcfg)
    whole.run(4)
    first = _trainer(tcfg, str(tmp_path))
    first.run(2)
    resumed = _trainer(tcfg, str(tmp_path), is_continue=True)
    resumed.run(2)
    assert [lo.loss for lo in resumed.losses] == \
        [lo.loss for lo in whole.losses[2:]]
    for a, b in zip(tckpt.train_state_leaves(resumed.state),
                    tckpt.train_state_leaves(whole.state)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Renders and mesh export of a background model
# --------------------------------------------------------------------------

VIEW_RES = (12, 16)


def _view():
    scene = make_sphere_scene(3, (24, 32))
    intr = scene.intrinsics[0].copy()
    intr[:2] *= 0.5
    return scene, scene.poses[0], intr


def test_render_depth_bg_matches_jax():
    """Unclamped sweeps, the sampler's last column (the sphere's exit)
    dropped: without the drop the depths would differ by an interval."""
    jcfg, tcfg = small_bmvs_configs()
    jp, tp = bg_params_pair(jcfg, seed=6)
    _, pose, intr = _view()
    want = jrender.render_depth(jp, jcfg.model, pose, intr, VIEW_RES,
                                chunk=64, fast=-1)
    got = trender.render_depth(tp, tcfg.model, pose, intr, VIEW_RES,
                               chunk=64, fast=-1)
    for name in ("depth", "acc"):
        np.testing.assert_allclose(got[name], want[name], atol=2e-4,
                                   err_msg=name)


def test_render_image_bg_matches_jax():
    jcfg, tcfg = small_bmvs_configs()
    jp, tp = bg_params_pair(jcfg, seed=6)
    scene, pose, intr = _view()
    near = scene.poses[1]
    want = jrender.render_image(jp, jcfg.model, pose, intr, VIEW_RES,
                                chunk=64, fast=-1, with_background=True,
                                near_pose=near)
    got = trender.render_image(tp, tcfg.model, pose, intr, VIEW_RES,
                               chunk=48, fast=-1, near_pose=near)
    for name in ("rgb", "depth", "normal", "acc"):
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], atol=2e-4,
                                   err_msg=name)
    own = trender.render_image(tp, tcfg.model, pose, intr, VIEW_RES,
                               chunk=48, fast=-1)
    assert np.abs(own["rgb"] - got["rgb"]).max() > 1e-4


def test_export_mesh_bg_is_unclamped(fixtures, tmp_path):
    """export_mesh of a background model sweeps the SDF at
    bounding_sphere 0, and on the JAX SDF values writes JAX's mesh."""
    _, jroot = fixtures
    jcfg, tcfg = small_bmvs_configs()
    jcfg.parallel.shard_eval = False
    jp, tp = bg_params_pair(jcfg, seed=2)
    js = jload_scene("BlendedMVS", RES, 1, -1, jroot)
    ts = tload_scene("BlendedMVS", RES, 1, -1, jroot)
    jply = jnvs.export_mesh(jcfg, js, jp, str(tmp_path / "j.ply"),
                            resolution=32)
    seen = []

    def jax_values(pts):
        return torch.from_numpy(jmesh.eval_sdf_grid(
            lambda x: jsdf_values(jp["sdf"], jcfg.model, x, 0.0), pts.numpy()))
    jax_values.device = torch.device("cpu")

    def mesh_sdf_fn(params, mcfg, bounding):
        seen.append(bounding)
        return jax_values
    mp = pytest.MonkeyPatch()
    mp.setattr(tnvs, "mesh_sdf_fn", mesh_sdf_fn)
    try:
        tply = tnvs.export_mesh(tcfg, ts, tp, str(tmp_path / "t.ply"),
                                resolution=32)
    finally:
        mp.undo()
    assert seen == [0.0]
    np.testing.assert_allclose(tio.load_ply(tply)[0], tio.load_ply(jply)[0],
                               rtol=0, atol=np.spacing(np.float32(200.0)))


# --------------------------------------------------------------------------
# The BMVS evaluation
# --------------------------------------------------------------------------

def _write_obj(path, seed):
    """A small OBJ: an icosphere-like cloud of triangles with slash-style
    and negative indices and a quad."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(40, 3)) * 50
    lines = [f"v {x:.6f} {y:.6f} {z:.6f}" for x, y, z in v]
    lines += [f"vt 0.{i} 0.{i}" for i in range(5)]
    for k in range(30):
        a, b, c = rng.choice(40, 3, replace=False) + 1
        lines.append(f"f {a}/1 {b}/2/1 {c}//1" if k % 2 else f"f {a} {b} {c}")
    lines.append("f -1 -2 -3 -4")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def test_save_bmvs_gt_matches_jax(tmp_path):
    ds = str(tmp_path / "meshes")
    for i in range(2):
        _write_obj(os.path.join(ds, scan2hash("scan3"), "textured_mesh",
                                f"part{i}.obj"), i)
    out = {}
    for name, mod in (("t", tgeo), ("j", jgeo)):
        root = str(tmp_path / name)
        path = mod.save_bmvs_gt(3, ds, root, n_samples=5000, crop_min_z=0.0,
                                rng=np.random.default_rng(9))
        out[name] = [tio.load_ply(os.path.join(root, "BlendedMVS", "stl", f))[0]
                     for f in ("scan3.ply", "scan3_crop.ply")]
        assert path.endswith("scan3_crop.ply")
    for a, b in zip(out["t"], out["j"]):
        np.testing.assert_array_equal(a, b)
    assert out["t"][0].shape == (5000, 3) and 0 < len(out["t"][1]) < 5000
    with pytest.raises(FileNotFoundError):
        tgeo.save_bmvs_gt(4, ds, str(tmp_path / "t"))


def test_cli_eval_bmvs_matches_jax(tmp_path):
    root, pred = str(tmp_path / "data"), str(tmp_path / "pred")
    rng = np.random.default_rng(5)
    gt = rng.normal(size=(3000, 3)).astype(np.float32) * 30
    tio.save_ply(os.path.join(root, "BlendedMVS", "stl", "scan2.ply"), gt)
    ply = os.path.join(pred, "mvsnet002_l3.ply")
    # Within the protocol's 20 mm at scan2's relative scale (1.57e-3):
    # 0.031 units.
    tio.save_ply(ply, gt[:2000] + 0.005 * rng.normal(size=(2000, 3)).astype(
        np.float32))
    got = tcli_bmvs.main(["--datadir", pred, "--data_dir_root", root,
                          "--scan", "2", "--no_crop"])
    want = jgeo.eval_bmvs_scan(ply, 2, root, no_crop=True)
    assert np.isfinite(want["overall"])
    assert got == [pytest.approx(want["overall"], rel=1e-6)]
    assert tcli_bmvs.main(["--datadir", pred, "--data_dir_root", root,
                           "--scan", "3", "--no_crop"]) == []
    ds = str(tmp_path / "meshes")
    _write_obj(os.path.join(ds, scan2hash("scan2"), "textured_mesh", "a.obj"),
               1)
    assert tcli_bmvs.main(["--save_gt", "--scan", "2", "--dataset_dir", ds,
                           "--data_dir_root", root, "--sample", "100"]) == []
    assert tio.load_ply(os.path.join(root, "BlendedMVS", "stl",
                                     "scan2.ply"))[0].shape == (100, 3)


SMALL_BMVS = ["model.implicit.dims=[32,32,32,32]", "model.implicit.skip_in=[2]",
              "model.implicit.multires=4", "model.rendering.dims=[32,32]",
              "model.feature_vector_size=32", "model.bg.implicit.dims=[32,32]",
              "model.bg.implicit.skip_in=[]", "model.bg.feature_vector_size=32",
              "model.bg.rendering.dims=[32]",
              "model.sampler.N_samples_eval=24", "model.sampler.N_samples=16",
              "model.sampler.N_samples_extra=4",
              "model.sampler.N_samples_inverse_sphere=4",
              "train.num_pixels=16", f"dataset.img_res=[{RES[0]},{RES[1]}]",
              "train.train_compute_dtype=float32",
              "train.train_activation_dtype=float32"]


def test_cli_eval_vsdf_bmvs_end_to_end_cpu(fixtures, tmp_path):
    """A two-step background trainer on the BMVS fixture at 64x96 writes
    its checkpoint; `eval_vsdf --conf bmvs` renders every eval view and
    the three training views with their near poses and exports the mesh,
    then scores the renders against the masked images."""
    _, jroot = fixtures
    cfg = tconfig.load_config("bmvs", overrides=SMALL_BMVS)
    cfg.exps_folder = str(tmp_path / "exps_vsdf")
    scene = tload_scene("BlendedMVS", RES, 1, 3, jroot)
    trainer = ttrainer.VolTrainer(cfg, scene, "scan1", device="cpu",
                                  exps_root=str(tmp_path))
    trainer.run(2)
    evals = str(tmp_path / "exps_result")
    common = ["--conf", "bmvs", "--scan_ids", "1", "--exps_folder",
              cfg.exps_folder, "--evals_folder", evals, "--data_dir_root",
              jroot, "--override"] + SMALL_BMVS
    assert tcli_vsdf.main(["--eval_rendering", "--eval_mesh", "--resolution",
                           "24"] + common, device="cpu") == []
    images = os.path.join(evals, "ours_1", f"rendering_{trainer.epoch}")
    views = scene.eval_ids() + TRAIN_IDS
    for v in views:
        assert os.path.isfile(os.path.join(images, f"eval_{v:03d}.png")), v
    v = views[0]
    maps = trender.render_image(trainer.state.params, cfg.model,
                                scene.poses[v], scene.intrinsics[v], RES,
                                near_pose=scene.near_pose(v))
    np.testing.assert_array_equal(
        tio.read_png(os.path.join(images, f"eval_{v:03d}.png")),
        (np.clip(maps["rgb"], 0, 1) * 255).astype(np.uint8))
    assert os.path.isfile(os.path.join(evals, "ours_1", "mesh", "scan1.ply"))
    (res,) = tcli_vsdf.main(["--eval_rendering", "--result_from", "default"]
                            + common, device="cpu")
    assert res["n_views"] == len(scene.eval_ids())
    assert np.isfinite(res["psnr_mean"]) and 0 < res["ssim_mean"] <= 1
