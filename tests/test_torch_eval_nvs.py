"""The port's novel-view evaluation and mesh export (engine/eval_nvs.py,
utils/metrics.py, models/lpips.py, the scene's eval masks) against the
JAX package's.

- `masked_psnr` and `ssim` equal the JAX functions exactly (the same
  numpy and scipy code).
- `lpips_distance` with random-init weights (the JAX init, bridged) is
  within 1e-5 relative of the JAX one.
- `find_checkpoint` gives the JAX answers on the same directory tree.
- `SceneData.masks` and `eval_ids` equal JAX `load_scene`'s on a DTU
  fixture with held-out views and masks.
- `eval_rendered_views` on the same PNGs and masks: PSNR and SSIM
  equal, LPIPS (weights from a JAX checkpoint) within 1e-5 relative
  (its std over the two views within 1e-5 of the mean).
- `export_mesh` on the fixture with a bbs.npz: fed the JAX SDF's grid
  values it writes the JAX package's mesh (vertices within one float32
  ulp of its scale, faces equal); with its own SDF, equal counts.
"""


import jax
import numpy as np
import pytest
import torch

from s_volsdf_tpu.data.scene_dataset import load_scene as jload_scene
from s_volsdf_tpu.engine import eval_nvs as jnvs
from s_volsdf_tpu.engine import mesh as jmesh
from s_volsdf_tpu.models import lpips as jlpips
from s_volsdf_tpu.models.network import sdf_values as jsdf_values
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu.utils import metrics as jmetrics
from s_volsdf_tpu_torch.bridge import lpips_from_jax
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.data.scene_dataset import load_scene as tload_scene
from s_volsdf_tpu_torch.engine import eval_nvs as tnvs
from s_volsdf_tpu_torch.models import lpips as tlpips
from s_volsdf_tpu_torch.utils import metrics as tmetrics
from test_torch_config import params_pair, small_configs

RES = (32, 48)
N_EVAL = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _images(seed, n=2, shape=(40, 56)):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n,) + shape + (3,)).astype(np.float32)


def test_psnr_and_ssim_match_jax():
    a, b = _images(0, 1)[0], _images(1, 1)[0]
    mask = (np.random.default_rng(2).uniform(size=a.shape) > 0.3
            ).astype(np.float32)
    for m in (None, mask):
        assert tmetrics.masked_psnr(a, b, m) == jmetrics.masked_psnr(a, b, m)
    for dr in (1.0, 2.0):
        assert tmetrics.ssim(a, b, data_range=dr) == \
            jmetrics.ssim(a, b, data_range=dr)
    assert tmetrics.ssim(a[..., 0], b[..., 0]) == \
        jmetrics.ssim(a[..., 0], b[..., 0])


@pytest.fixture(scope="module")
def lpips_pair():
    jp = jlpips.init_lpips_params(jax.random.PRNGKey(0))
    return jp, lpips_from_jax(jax.tree.map(np.asarray, jp))


def test_lpips_matches_jax(lpips_pair):
    jp, model = lpips_pair
    a, b = _images(3), _images(4)
    want = np.asarray(jlpips.lpips_distance(jp, a, b))
    got = tlpips.lpips_distance(model, torch.as_tensor(a),
                                torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert np.all(want > 0)
    same = tlpips.lpips_distance(model, torch.as_tensor(a),
                                 torch.as_tensor(a)).numpy()
    assert np.all(same == 0)


def test_init_lpips_params_has_the_jax_leaves(lpips_pair):
    jp, _ = lpips_pair
    want = [np.shape(x) for x in jax.tree_util.tree_leaves(jp)]
    got = tlpips.lpips_leaves(tlpips.init_lpips_params(
        np.random.default_rng(0)))
    assert [x.shape for x in got] == want
    assert [x.shape for x in tlpips._shapes()] == want


def test_find_checkpoint_matches_jax(tmp_path):
    exp = tmp_path / "exps" / "ours_106"
    for ts, labels in (("2024_01_01", ["latest", "epoch_3"]),
                       ("2024_02_01", ["epoch_3"]), ("2024_03_01", [])):
        for label in labels:
            d = exp / ts / "checkpoints" / label
            d.mkdir(parents=True)
            (d / "state.npz").write_bytes(b"")
        (exp / ts).mkdir(parents=True, exist_ok=True)
    cases = [(str(exp), "latest", "latest", ""),
             (str(exp), "epoch_3", "latest", ""),
             (str(exp), "latest", "2024_02_01", ""),
             (str(exp), "epoch_3", "2024_02_01", ""),
             (str(exp), "epoch_9", "latest", ""),
             (str(tmp_path / "none"), "latest", "latest", ""),
             ("", "latest", "latest", str(exp / "2024_01_01")),
             ("", "latest", "latest", str(exp / "2024_03_01"))]
    for args in cases:
        assert tnvs.find_checkpoint(*args) == jnvs.find_checkpoint(*args), args


@pytest.fixture(scope="module")
def fixture_scenes(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("nvs") / "data")
    make_dtu_fixture(root, scan_id=106, img_res=RES, n_eval_views=N_EVAL)
    return (root, jload_scene("DTU", RES, 106, -1, root),
            tload_scene("DTU", RES, 106, -1, root))


def test_scene_masks_and_eval_ids_match_jax(fixture_scenes):
    _, js, ts = fixture_scenes
    assert ts.eval_ids() == js.eval_ids()
    assert ts.masks.shape == js.masks.shape
    np.testing.assert_array_equal(ts.masks, js.masks)
    held_out = ts.eval_ids()[:N_EVAL]
    assert all(0 < ts.masks[v].mean() < 1 for v in held_out)
    assert ts.near_pose(held_out[0]) is None


def test_eval_rendered_views_matches_jax(fixture_scenes, lpips_pair,
                                         tmp_path):
    _, js, ts = fixture_scenes
    jp, _ = lpips_pair
    weights = str(tmp_path / "lpips")
    jckpt.save_state(weights, jax.tree.map(np.asarray, jp))
    rng = np.random.default_rng(6)
    for vid in ts.eval_ids()[:N_EVAL]:
        img = ts.rgb[vid].reshape(*RES, 3) + rng.normal(0, 0.05, RES + (3,))
        tio.write_png(str(tmp_path / f"eval_{vid:03d}.png"),
                      (np.clip(img, 0, 1) * 255).astype(np.uint8))
    jcfg, tcfg = small_configs()
    seconds = []
    got = tnvs.eval_rendered_views(tcfg, ts, str(tmp_path), "default",
                                   weights, seconds=seconds)
    want = jnvs.eval_rendered_views(jcfg, js, str(tmp_path), "default",
                                    weights)
    assert got["n_views"] == want["n_views"] == N_EVAL == len(seconds)
    for k in ("psnr_mean", "psnr_std", "ssim_mean", "ssim_std"):
        assert got[k] == want[k], k
    assert got["lpips_mean"] == pytest.approx(want["lpips_mean"], rel=1e-5)
    # The std of two near-equal distances: held to 1e-5 of the mean.
    assert got["lpips_std"] == pytest.approx(
        want["lpips_std"], abs=1e-5 * want["lpips_mean"])
    none = tnvs.eval_rendered_views(tcfg, ts, str(tmp_path), "default")
    assert none["lpips_mean"] is None and none["psnr_mean"] == got["psnr_mean"]


def test_export_mesh_matches_jax(fixture_scenes, tmp_path):
    root, js, ts = fixture_scenes
    jcfg, tcfg = small_configs()
    jcfg.parallel.shard_eval = False
    jp, tp = params_pair(jcfg, seed=2)
    bbs = str(tmp_path / "bbs.npz")
    np.savez(bbs, scan106=np.array([[-0.7, -0.6, -0.5], [0.6, 0.7, 0.5]]))
    jply = jnvs.export_mesh(jcfg, js, jp, str(tmp_path / "j.ply"),
                            resolution=32, bbs_file=bbs)
    want_v, want_f = tio.load_ply(jply)[0], _faces(jply)
    bs = jcfg.model.scene_bounding_sphere

    def jfn(pts):
        return jsdf_values(jp["sdf"], jcfg.model, pts, bs)

    def jax_values(pts):      # the JAX grid evaluation, as in its export
        return torch.from_numpy(jmesh.eval_sdf_grid(jfn, pts.numpy()))
    jax_values.device = torch.device("cpu")
    mp = pytest.MonkeyPatch()
    mp.setattr(tnvs, "mesh_sdf_fn", lambda *a: jax_values)
    try:
        tply = tnvs.export_mesh(tcfg, ts, tp, str(tmp_path / "t0.ply"),
                                resolution=32, bbs_file=bbs)
    finally:
        mp.undo()
    np.testing.assert_allclose(tio.load_ply(tply)[0], want_v, rtol=0,
                               atol=np.spacing(np.float32(200.0)))
    np.testing.assert_array_equal(_faces(tply), want_f)
    stats = {}
    tply = tnvs.export_mesh(tcfg, ts, tp, str(tmp_path / "t.ply"),
                            resolution=32, bbs_file=bbs, stats=stats)
    got_v = tio.load_ply(tply)[0]
    assert got_v.shape == want_v.shape and _faces(tply).shape == want_f.shape
    assert stats["verts"] == got_v.shape[0] and len(stats["component"]) == 2
    assert [g["points"] for g in stats["grids"]] == [100 ** 3, 32 ** 3]


def _faces(ply):
    from s_volsdf_tpu_torch.engine.eval_geo import _load_mesh
    return _load_mesh(ply)[1]
