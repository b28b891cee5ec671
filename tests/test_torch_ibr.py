"""The port's image-based rendering (engine/ibr.py, cli/ibr.py,
`create_scene=true`) and the cv2 operations it carries in torch
(utils/image.py) against cv2 and the JAX package, on the CPU.

Tolerances:
- `pyr_down`, `pyr_up` against cv2 at odd and even sizes, float64:
  1e-12 (measured 0 and 2.2e-16: cv2 writes a row's edge sums apart);
- `remap_cubic` against cv2.remap(INTER_CUBIC) on float32: 1e-6 (cv2
  sums in float32, the port in float64), and the pixels cv2 sets to 0
  (all taps outside, NaN, far coordinates) exactly 0;
- `erode5`: bit-exact (a minimum);
- `laplacian_blending` against the JAX package's: 1e-12; the view
  directions: 1e-6 (float32 outputs);
- `create_scene`: the same cam files (layout equal, numbers within
  1e-6 relative: the IDR cameras' decomposition rounds apart, scipy's
  RQ in the port, cv2's in the JAX package), equal pixels;
- `image_based_render`: the float blend within 1e-5, the written uint8
  PNGs equal on >= 99.9% of the values and never more than 1 apart
  (`(blend * 255).astype(uint8)` truncates: a value within 1e-5 of an
  integer edge may land on either side).
"""

import os
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s_volsdf_tpu import config as jconfig  # noqa: E402
from s_volsdf_tpu.cli import ibr as jcli_ibr  # noqa: E402
from s_volsdf_tpu.cli import run as jrun  # noqa: E402
from s_volsdf_tpu.data import io as jio  # noqa: E402
from s_volsdf_tpu.data.fixtures import make_dtu_fixture  # noqa: E402
from s_volsdf_tpu.data.synthetic import make_sphere_scene  # noqa: E402
from s_volsdf_tpu.engine import ibr as jibr  # noqa: E402
from s_volsdf_tpu_torch.cli import ibr as tcli_ibr  # noqa: E402
from s_volsdf_tpu_torch.cli import run as trun  # noqa: E402
from s_volsdf_tpu_torch.data import io as tio  # noqa: E402
from s_volsdf_tpu_torch.engine import ibr as tibr  # noqa: E402
from s_volsdf_tpu_torch.utils import image as timage  # noqa: E402

PYR_TOL = 1e-12
REMAP_TOL = 1e-6
BLEND_TOL = 1e-12
DIRS_TOL = 1e-6
IBR_TOL = 1e-5
# The cams' numbers: the port decomposes the IDR projection with scipy's
# RQ, the JAX package with cv2's; they differ by float rounding (a skew
# of 1e-15 against 0, a last digit of a float32).
CAM_RTOL, CAM_ATOL = 1e-6, 1e-9
TRAIN_IDS, EVAL_ID = [25, 22, 28], 1   # DTU training ids; a DTU eval id
SIZES = [(6, 7), (7, 6), (8, 8), (9, 13), (1, 5), (5, 1), (2, 3), (64, 96),
         (75, 33)]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- cv2's operations --------------------------------------------------------

@pytest.mark.parametrize("hw", SIZES)
def test_pyr_down_matches_cv2(hw):
    a = np.random.default_rng(0).random(hw + (3,))
    got = timage.pyr_down(torch.as_tensor(a)).numpy()
    want = cv2.pyrDown(a)
    assert got.shape == want.shape == ((hw[0] + 1) // 2, (hw[1] + 1) // 2, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PYR_TOL)


@pytest.mark.parametrize("hw", SIZES)
def test_pyr_up_matches_cv2(hw):
    a = np.random.default_rng(1).random(hw + (3,))
    got = timage.pyr_up(torch.as_tensor(a)).numpy()
    want = cv2.pyrUp(a)
    assert got.shape == want.shape == (2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=PYR_TOL)


@pytest.mark.parametrize("hw", [(6, 7), (7, 6), (8, 9)])
def test_pyr_up_edges(hw):
    """A delta at the far corner gives [4, 7, 8] / 8 as the last three
    outputs of each axis (the far edge repeats), one at the near corner
    [6, 4, 1] / 8 (reflect-101), as cv2 does."""
    far = np.zeros(hw + (1,))
    far[-1, -1] = 1.0
    near = np.zeros(hw + (1,))
    near[0, 0] = 1.0
    for a, sl, want in ((far, slice(-3, None), [4, 7, 8]),
                        (near, slice(0, 3), [6, 4, 1])):
        got = timage.pyr_up(torch.as_tensor(a)).numpy()[..., 0]
        edge = 8 if a is far else 6
        np.testing.assert_allclose(got[-1 if a is far else 0, sl] * 64 / edge,
                                   want, atol=PYR_TOL)
        np.testing.assert_allclose(got[sl, -1 if a is far else 0] * 64 / edge,
                                   want, atol=PYR_TOL)
        np.testing.assert_allclose(got, cv2.pyrUp(a[..., 0]), atol=PYR_TOL)


def test_pyramid_of_odd_size_raises_like_cv2():
    """A Laplacian level of an odd-sized image: pyrUp of the coarser
    level is one row larger than the finer one, and the subtraction
    refuses, in cv2 and in the port."""
    a = np.random.default_rng(2).random((75, 32, 3))
    with pytest.raises(cv2.error):
        jibr._laplacian_pyramid(a, 2, False)
    with pytest.raises(ValueError, match="subtract"):
        tibr._laplacian_pyramid(torch.as_tensor(a), 2, False)
    with pytest.raises(ValueError, match="add"):
        timage.add(torch.zeros(2, 3, 1), torch.zeros(3, 3, 1))


def _remap_case():
    rng = np.random.default_rng(3)
    img = rng.random((20, 30, 3)).astype(np.float32)
    mx = rng.uniform(-4, 34, (40, 50)).astype(np.float32)
    my = rng.uniform(-4, 24, (40, 50)).astype(np.float32)
    # Interior, edge, just outside, far outside, NaN, huge.
    mx[0, :10] = [4.3, 4.31, 4.314, 0.0, 29.0, -1.2, -2.0, np.nan, 1e9, -1e9]
    my[0, :10] = [7.1, 7.1, 7.1, 0.0, 19.0, 5.5, 3.0, 3.0, 3.0, 3.0]
    mx[1, :4] = [10.5, 10.5, 10.5, 10.5]
    my[1, :4] = [-1.5, 19.5, np.nan, 1e9]
    return img, mx, my


def test_remap_cubic_matches_cv2():
    img, mx, my = _remap_case()
    want = cv2.remap(img, mx, my, interpolation=cv2.INTER_CUBIC)
    got = timage.remap_cubic(torch.as_tensor(img), torch.as_tensor(mx),
                             torch.as_tensor(my)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=REMAP_TOL)
    np.testing.assert_array_equal(got == 0, want == 0)
    assert (want == 0).any() and (want[0, 5] != 0).all()   # x = -1.2


def test_remap_cubic_is_continuous():
    """OpenCV 5 does not round float maps to 1/32 pixel: at x = 4.3,
    4.31, 4.314 the result moves with x (OpenCV 4 gives the same value
    for the last two)."""
    img, mx, my = _remap_case()
    got = timage.remap_cubic(torch.as_tensor(img), torch.as_tensor(mx[:1, :3]),
                             torch.as_tensor(my[:1, :3])).numpy()
    assert len({tuple(v) for v in got[0]}) == 3


def test_erode_matches_cv2():
    m = (np.random.default_rng(4).random((31, 40, 3)) > 0.15).astype(
        np.float64)
    got = timage.erode5(torch.as_tensor(m)).numpy()
    np.testing.assert_array_equal(got, cv2.erode(m, np.ones((5, 5), np.uint8)))
    batched = timage.erode5(torch.as_tensor(np.stack([m, 1 - m]))).numpy()
    np.testing.assert_array_equal(batched[1], cv2.erode(
        1 - m, np.ones((5, 5), np.uint8)))


# -- against the JAX package -------------------------------------------------

def test_laplacian_blending_matches_jax():
    rng = np.random.default_rng(5)
    imgs = rng.random((4, 64, 96, 3))
    masks = rng.random((4, 64, 96, 3))
    masks /= masks.sum(axis=0, keepdims=True)
    want = jibr.laplacian_blending(imgs, masks, num_levels=4)
    got = tibr.laplacian_blending(torch.as_tensor(imgs),
                                  torch.as_tensor(masks), 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=BLEND_TOL)


@pytest.mark.parametrize("skew", [0.0, 0.7])
def test_dirs_for_view_matches_jax(skew):
    K = np.array([[300.0, skew, 47.5], [0, 310.0, 31.5], [0, 0, 1]],
                 np.float32)
    c, s = np.cos(0.3), np.sin(0.3)
    extr = np.array([[c, 0, s, 0.1], [0, 1, 0, -0.2], [-s, 0, c, 2.5],
                     [0, 0, 0, 1]], np.float32)
    want, centre = jibr._dirs_for_view(K, extr, (64, 96))
    got, got_centre = tibr._dirs_for_view(K, extr, (64, 96), "cpu")
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=DIRS_TOL)
    np.testing.assert_array_equal(got_centre, centre)


def _write_ibr_inputs(scan_folder, out_folder):
    """tests/test_ibr.py's scene: three training views and one eval view
    of the sphere on a ring, their GT depths (the background at twice
    the farthest depth), PNG training images and the eval render."""
    scene = make_sphere_scene(n_views=4, img_res=(64, 96), cam_radius=2.5)
    for i, vid in enumerate(TRAIN_IDS + [EVAL_ID]):
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.linalg.inv(scene.poses[i])
        cam[1, :3, :3] = scene.intrinsics[i][:3, :3]
        jio.write_cam(os.path.join(scan_folder, f"cams/{vid:08d}_cam.txt"),
                      cam)
        depth = scene.depths[i].copy()
        depth[~np.isfinite(depth)] = depth[np.isfinite(depth)].max() * 2
        jio.save_pfm(os.path.join(out_folder, f"depth_est/{vid:08d}.pfm"),
                     depth.astype(np.float32))
        img = (np.clip(scene.images[i], 0, 1) * 255).astype(np.uint8)
        path = (os.path.join(out_folder, f"eval_{vid:03d}.png")
                if vid == EVAL_ID else
                os.path.join(scan_folder, f"images/{vid:08d}.png"))
        os.makedirs(os.path.dirname(path), exist_ok=True)
        imageio.imwrite(path, img)
    return scene


def _record_blends(monkeypatch, module, blends):
    blend = module.laplacian_blending

    def recording(*args, **kwargs):
        out = blend(*args, **kwargs)
        blends.append(np.asarray(out))
        return out
    monkeypatch.setattr(module, "laplacian_blending", recording)
    monkeypatch.setattr(module, "get_eval_ids", lambda *a, **k: [EVAL_ID])


def _assert_pngs_match(got_path, want_path):
    got, want = imageio.imread(got_path), imageio.imread(want_path)
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, (
        diff.max(), (diff != 0).sum())


def test_image_based_render_matches_jax(tmp_path, monkeypatch):
    scan_folder = str(tmp_path / "scan106")
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    scene = _write_ibr_inputs(scan_folder, jout)
    _write_ibr_inputs(scan_folder, tout)
    jblends, tblends = [], []
    _record_blends(monkeypatch, jibr, jblends)
    _record_blends(monkeypatch, tibr, tblends)
    (jpath,) = jibr.image_based_render(scan_folder, jout, "DTU", 3)
    (tpath,) = tibr.image_based_render(scan_folder, tout, "DTU", 3,
                                       device="cpu")
    assert os.path.basename(tpath) == os.path.basename(jpath) == \
        f"eval_blend_{EVAL_ID:03d}.png"
    np.testing.assert_allclose(tblends[0], jblends[0], rtol=0, atol=IBR_TOL)
    _assert_pngs_match(tpath, jpath)
    blend = tio.read_img(tpath)
    psnr = -10 * np.log10(np.mean((blend - scene.images[3]) ** 2))
    assert psnr > 20, psnr


def test_image_based_render_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tibr.image_based_render(str(tmp_path / "scan106"), str(tmp_path),
                                "DTU", 3)


SCENE_OVERRIDES = ["max_h=64", "max_w=96", "dataset.img_res=[64,96]",
                   "mvs.numdepth=16", "mvs.ndepths=[16,8,8]",
                   "mvs.x2_mvsres=false",
                   "testlist=scan106"]


def test_create_scene_matches_jax(tmp_path):
    """`cli.run create_scene=true` in both packages on one DTU fixture:
    the same cam files (training and eval views) and the same training
    images; nothing else runs."""
    data = str(tmp_path / "data")
    make_dtu_fixture(data, scan_id=106, img_res=(64, 96))
    outs = {}
    for name, run in (("jax", jrun.main),
                      ("port", lambda a: trun.main(a, device="cpu"))):
        outs[name] = str(tmp_path / name)
        assert not run(["create_scene=true", f"data_dir_root={data}",
                        f"dataset.data_dir_root={data}",
                        f"outdir={outs[name]}"] + SCENE_OVERRIDES)
    jdir, tdir = (os.path.join(outs[k], "scan106") for k in ("jax", "port"))
    cams = sorted(os.listdir(os.path.join(jdir, "cams")))
    images = sorted(os.listdir(os.path.join(jdir, "images")))
    assert sorted(os.listdir(os.path.join(tdir, "cams"))) == cams
    assert sorted(os.listdir(os.path.join(tdir, "images"))) == images
    assert len(images) == 3 and len(cams) > len(images)
    for f in cams:
        with open(os.path.join(jdir, "cams", f)) as a, \
                open(os.path.join(tdir, "cams", f)) as b:
            want, got = a.read().split("\n"), b.read().split("\n")
        assert [len(r.split()) for r in got] == [len(r.split()) for r in want]
        want, got = (np.array([float(x) for r in t[1:] for x in r.split()
                               if r and r[0] in "-0123456789"])
                     for t in (want, got))
        np.testing.assert_allclose(got, want, rtol=CAM_RTOL, atol=CAM_ATOL,
                                   err_msg=f)
    for f in images:
        np.testing.assert_array_equal(
            tio.read_image(os.path.join(tdir, "images", f)),
            imageio.imread(os.path.join(jdir, "images", f)))
    assert not os.path.exists(os.path.join(outs["port"], "mvsnet106_l3.ply"))


# -- cli.ibr -----------------------------------------------------------------

def _exit_message(main, argv):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    return str(exc.value)


def test_cli_ibr_exits_like_jax(tmp_path):
    """Conflicting presets, no eval dir, no all-digit rendering_<N>
    directory (a rendering_tmp directory and a rendering_7 file do not
    count), no scene export: the JAX command line's SystemExit, word for
    word."""
    evals, out = tmp_path / "evals", tmp_path / "out"
    base = [f"evals_folder={evals}", f"outdir={out}", "testlist=scan106"]
    evaldir = evals / "ours_106"

    def exits_alike(argv, words):
        want = _exit_message(jcli_ibr.main, argv)
        assert _exit_message(lambda a: tcli_ibr.main(a, device="cpu"),
                             argv) == want
        assert words in want

    exits_alike(["preset=dtu", "vol=bmvs"] + base, "conflicting")
    exits_alike(base, "no eval dir")
    (evaldir / "rendering_tmp").mkdir(parents=True)
    (evaldir / "rendering_7").write_text("a file")
    exits_alike(base, "no rendering_<epoch> dirs")
    (evaldir / "rendering_3").mkdir()
    exits_alike(base, "no scene export")


def test_cli_ibr_blends_the_newest_rendering(tmp_path, monkeypatch):
    """The newest all-digit rendering_<N> directory gets the blends."""
    evaldir = tmp_path / "evals" / "ours_106"
    (evaldir / "rendering_9").mkdir(parents=True)
    (evaldir / "rendering_x12").mkdir()
    newest = str(evaldir / "rendering_10")
    _write_ibr_inputs(str(tmp_path / "out" / "scan106"), newest)
    monkeypatch.setattr(tibr, "get_eval_ids", lambda *a, **k: [EVAL_ID])
    written = tcli_ibr.main([f"evals_folder={tmp_path / 'evals'}",
                             f"+outdir={tmp_path / 'out'}",
                             "testlist=scan106"], device="cpu")
    assert written == [os.path.join(newest, f"eval_blend_{EVAL_ID:03d}.png")]
    assert os.path.exists(written[0])
    assert jconfig.load_config("dtu").train.expname == "ours"
