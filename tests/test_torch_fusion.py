"""The port's depth fusion (engine/fusion.py, ops/geo_consistency.py, the
eval-mask image ops of utils/image.py) against the JAX package's.

Tolerances:
- geometric consistency, the port's plain version against the JAX
  package's host C++ core and its numpy oracle: masks equal, the
  reprojected depth within 1e-12, the source x/y within 1e-9 (the plain
  version repeats the C++ core's order of operations; measured 0
  against it, and up to 3e-15 / 1.5e-14 against the numpy oracle,
  which multiplies the matrices in another order);
- `fuse_views` and `filter_depth`: equal point counts, xyz within one
  float32 ulp (the back-projection's float64 products are summed in
  another order than numpy's), rgb equal;
- the eval mask: cv2's ellipse and dilation equal; the linear resize
  equal to cv2's own code path bit for bit and, with cv2's default IPP
  path, equal in which pixels are non-zero (the only use of its values).
"""

import os

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from s_volsdf_tpu.data import synthetic as jsynth
from s_volsdf_tpu.engine import fusion as jfusion
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.engine import fusion as tfusion
from s_volsdf_tpu_torch.ops import geo_consistency as gc
from s_volsdf_tpu_torch.ops import build as tbuild
from s_volsdf_tpu_torch.utils import image as timage
from test_fusion_native import make_pair

DEPTH_TOL = 1e-12
XY_TOL = 1e-9
VIEWS = [25, 22, 28]


def _extr(angle, shift=(0.0, 0.0, 2.5)):
    c, s = np.cos(angle), np.sin(angle)
    E = np.eye(4)
    E[:3, :3] = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    E[:3, 3] = [0.1 * angle + shift[0], shift[1], shift[2]]
    return E


def _out_of_frustum_pair(case):
    """Pairs whose projections leave the source image: a wide rotation
    (most pixels out, the border band partial), a source camera behind
    part of the surface (clamped depths), float32 cameras as the cam
    files give."""
    d_ref, K, _, d_src, _, _ = make_pair(seed=5)
    if case == "wide":
        return d_ref, K, _extr(0.0), d_src, K, _extr(0.9)
    if case == "behind":
        return d_ref, K, _extr(0.0), d_src, K, _extr(2.5, (0.0, 0.0, -0.5))
    f = np.float32
    return (d_ref, K.astype(f), _extr(0.0).astype(f), d_src, K.astype(f),
            _extr(0.3, (0.4, -0.2, 2.0)).astype(f))


def _hold_to_jax(args, oracle=True):
    """The port against the JAX package's C++ core and, with `oracle`,
    its numpy version. (With float32 cameras the two JAX paths disagree
    by about 1e-6 relative: the numpy one inverts and multiplies the
    4x4 matrices separately, in float32.)"""
    got = [None if t is None else t.numpy()
           for t in tfusion.check_geometric_consistency(*args, 1.0, 0.01)]
    wants = [jfusion._geo_consistency_native(*args, 1.0, 0.01)]
    if oracle:
        wants.append(jfusion.check_geometric_consistency_np(*args, 1.0, 0.01))
    for want in wants:
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_allclose(got[1], want[1], rtol=0, atol=DEPTH_TOL)
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_allclose(g, w, rtol=XY_TOL, atol=XY_TOL)
    return got


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_geo_consistency_matches_jax(seed):
    got = _hold_to_jax(make_pair(seed))
    assert 0.05 < got[0].mean() < 0.95


@pytest.mark.parametrize("case", ["wide", "behind", "float32_cams"])
def test_geo_consistency_out_of_frustum(case):
    args = _out_of_frustum_pair(case)
    got = _hold_to_jax(args, oracle=case != "float32_cams")
    H, W = args[0].shape
    xs, ys = got[2], got[3]
    outside = (xs < -1) | (xs > W) | (ys < -1) | (ys > H)
    assert outside.any()
    assert not got[0][outside].any()


def test_geo_consistency_plain_matches_native_bitwise():
    """The plain version is the C++ core's arithmetic: not merely within
    the tolerance, but equal."""
    args = make_pair(3)
    mats = gc.pair_matrices(args[1], args[2], args[4], args[5])
    mask, depth, xs, ys = gc.geo_consistency_plain(
        torch.tensor(args[0]), torch.tensor(args[3]), mats, 1.0, 0.01,
        xy=True)
    want = jfusion._geo_consistency_native(*args, 1.0, 0.01)
    for g, w in zip((mask, depth, xs, ys), want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_geo_consistency_without_xy():
    args = make_pair(1)
    mask, depth, xs, ys = tfusion.check_geometric_consistency(
        *args, 1.0, 0.01, xy=False)
    assert xs is None and ys is None
    want = jfusion._geo_consistency_native(*args, 1.0, 0.01)
    np.testing.assert_array_equal(mask.numpy(), want[0])
    np.testing.assert_array_equal(depth.numpy(), want[1])


def test_reproject_with_depth_matches_jax():
    args = make_pair(2)
    got = tfusion.reproject_with_depth(*args)
    want = jfusion.reproject_with_depth(*args)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=XY_TOL, atol=XY_TOL)


def test_geo_consistency_build_needs_nvcc(monkeypatch, tmp_path):
    """No nvcc on PATH or under $CUDA_HOME: building raises naming nvcc
    (no fallback)."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    with pytest.raises(RuntimeError, match="nvcc"):
        gc.build(force=True)
    with pytest.raises(RuntimeError, match="nvcc"):
        tbuild.nvcc()


def test_geo_consistency_refuses_mixed_devices():
    d = torch.zeros((4, 5))
    with pytest.raises(ValueError, match="device"):
        gc.geo_consistency(d, d.to("meta"), gc.pair_matrices(
            *(np.eye(4)[:3, :3], np.eye(4)) * 2), 1.0, 0.01)


# -- fusion ---------------------------------------------------------------

def _sphere_views(res=(48, 64), seed=0):
    """Three views of the synthetic sphere: noisy z-depths (0 off the
    sphere), random confidences, float32 cameras, the rendered images."""
    scene = jsynth.make_sphere_scene(3, res, cam_radius=2.8)
    rng = np.random.default_rng(seed)
    views = []
    for v in range(3):
        d = np.where(np.isfinite(scene.depths[v]), scene.depths[v], 0.0)
        d = (d * (1 + 2e-3 * rng.standard_normal(d.shape))).astype(np.float32)
        views.append({
            "depth": d,
            "confidence": rng.random(res).astype(np.float32),
            "intrinsics": scene.intrinsics[v][:3, :3].astype(np.float32),
            "extrinsics": np.linalg.inv(scene.poses[v]).astype(np.float32),
            "image": scene.images[v].astype(np.float32)})
    return scene, views


def _assert_clouds_match(got, want):
    (gx, gc_), (wx, wc) = got, want
    assert gx.shape == wx.shape and gx.shape[0] > 0
    assert gx.dtype == wx.dtype == np.float32
    ulp = np.spacing(np.abs(wx))
    assert np.all(np.abs(gx - wx) <= ulp), np.abs(gx - wx).max()
    np.testing.assert_array_equal(gc_, wc)


def _jax_eval_mask(m, shape):
    kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (25, 25))
    m = cv2.dilate((m > 0).astype(np.uint8), kernel)
    return cv2.resize(m.astype(np.float32), shape[::-1])


@pytest.mark.parametrize("conf_thresh,thres_view", [(0.0, 1), (0.3, 2)])
def test_fuse_views_matches_jax(conf_thresh, thres_view):
    scene, views = _sphere_views()
    masks = [np.isfinite(scene.depths[v]).astype(np.uint8) * 255
             for v in range(3)]
    masks[1][:10] = 0
    jm = [_jax_eval_mask(m, (48, 64)) for m in masks]
    tm = [timage.dilate_binary(torch.tensor(m) > 0,
                                timage.ellipse_kernel(25)).float()
          for m in masks]
    kw = dict(conf_thresh=conf_thresh, thres_view=thres_view)
    xyz, rgb, stats = tfusion.fuse_views(views, eval_masks=tm, device="cpu",
                                         **kw)
    jxyz, jrgb, jstats = jfusion.fuse_views(views, eval_masks=jm, **kw)
    _assert_clouds_match((xyz, rgb), (jxyz, jrgb))
    assert stats == jstats


def test_fuse_views_defaults_to_cuda(monkeypatch):
    _, views = _sphere_views((16, 24))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfusion.fuse_views(views)


def write_scene_outputs(root, views, mask_res=None, jpeg=True):
    """A scene's output directory as the runner writes it: depth and
    confidence PFMs, cam files, images/*.png; with `jpeg` also the JAX
    package's images/*.jpg, whose decoded pixels the PNG holds (so both
    packages read the same colours); with `mask_res`, eval masks
    <root>/eval/mask/{v:03d}.png at that resolution. Returns the eval
    mask directory or None."""
    for v, view in zip(VIEWS, views):
        tio.save_pfm(os.path.join(root, f"depth_est/{v:08d}.pfm"),
                     view["depth"])
        tio.save_pfm(os.path.join(root, f"confidence/{v:08d}.pfm"),
                     view["confidence"])
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = view["extrinsics"]
        cam[1, :3, :3] = view["intrinsics"]
        tio.write_cam(os.path.join(root, f"cams/{v:08d}_cam.txt"), cam)
        img = (np.clip(view["image"], 0, 1) * 255).astype(np.uint8)
        if jpeg:
            jpg = os.path.join(root, f"images/{v:08d}.jpg")
            os.makedirs(os.path.dirname(jpg), exist_ok=True)
            cv2.imwrite(jpg, cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            img = np.asarray(imageio.imread(jpg))
        tio.write_png(os.path.join(root, f"images/{v:08d}.png"), img)
    if mask_res is None:
        return None
    mask_dir = os.path.join(root, "eval")
    for i, v in enumerate(VIEWS):
        m = np.zeros(mask_res, np.uint8)
        h, w = mask_res
        m[h // 4 + i:3 * h // 4, w // 5:4 * w // 5 - i] = 255
        tio.write_png(os.path.join(mask_dir, f"mask/{v:03d}.png"), m)
    return mask_dir


@pytest.mark.parametrize("mask_res", [None, (60, 80), (96, 128)])
def test_filter_depth_matches_jax(tmp_path, mask_res):
    """The file-level fusion on one directory: the JAX package reads the
    JPEGs, the port the PNGs beside them (same pixels). (96, 128) masks
    take cv2's exact-halving path, (60, 80) its linear one."""
    _, views = _sphere_views()
    root = str(tmp_path)
    mask_dir = write_scene_outputs(root, views, mask_res)
    jply, tply = str(tmp_path / "jax.ply"), str(tmp_path / "port.ply")
    jfusion.filter_depth(root, root, jply, VIEWS, eval_mask_dir=mask_dir)
    tfusion.filter_depth(root, root, tply, VIEWS, eval_mask_dir=mask_dir,
                         device="cpu")
    _assert_clouds_match(tio.load_ply(tply), tio.load_ply(jply))
    assert set(tfusion.filter_depth.last_seconds) == {"read", "fuse", "write"}


def test_filter_depth_missing_png_raises(tmp_path):
    _, views = _sphere_views((16, 24))
    write_scene_outputs(str(tmp_path), views, jpeg=False)
    os.remove(tmp_path / f"images/{VIEWS[1]:08d}.png")
    with pytest.raises(FileNotFoundError, match=f"{VIEWS[1]:08d}.png"):
        tfusion.filter_depth(str(tmp_path), str(tmp_path),
                             str(tmp_path / "x.ply"), VIEWS, device="cpu")


# -- the eval mask's image ops --------------------------------------------

@pytest.mark.parametrize("ksize", [3, 7, 25])
def test_ellipse_kernel_matches_cv2(ksize):
    np.testing.assert_array_equal(
        timage.ellipse_kernel(ksize),
        cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize)))


@pytest.mark.parametrize("shape", [(40, 60), (13, 90)])
def test_dilate_matches_cv2(shape):
    m = (np.random.default_rng(0).random(shape) > 0.97).astype(np.uint8)
    m[0, 0] = m[-1, -1] = 1
    k = timage.ellipse_kernel(25)
    got = timage.dilate_binary(torch.tensor(m), k).numpy()
    np.testing.assert_array_equal(got, cv2.dilate(m, k))


@pytest.mark.parametrize("src,dst", [((60, 80), (48, 64)),
                                     ((48, 64), (96, 128)),
                                     ((96, 128), (48, 64)),
                                     ((1200, 1600), (1152, 1536)),
                                     ((37, 53), (20, 31))])
def test_resize_linear_matches_cv2(src, dst):
    m = (np.random.default_rng(1).random(src) > 0.6).astype(np.float32)
    got = timage.resize_linear(torch.tensor(m), dst).numpy()
    ipp = cv2.resize(m, dst[::-1])
    np.testing.assert_array_equal(got > 0, ipp > 0)
    np.testing.assert_allclose(got, ipp, atol=1e-4)
    optimized, use_ipp = cv2.useOptimized(), cv2.ipp.useIPP()
    try:
        cv2.setUseOptimized(False)
        cv2.ipp.setUseIPP(False)
        np.testing.assert_array_equal(got, cv2.resize(m, dst[::-1]))
    finally:
        cv2.setUseOptimized(optimized)
        cv2.ipp.setUseIPP(use_ipp)
