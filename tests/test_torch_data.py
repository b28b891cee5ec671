"""The port's data path against the JAX package's: the PNG codec against
imageio, PFM, PLY and cam files, the depth visualisation, the
projection decomposition, the DTU fixture, `load_scene` and
`MVSDataset`. PLY bytes and visualisation pixels are equal.

Tolerances: PNG pixels, PFM arrays, fixture cameras and pixels, and the
hypothesis depths bit-equal; `load_K_Rt_from_P` 1e-5 (scipy's RQ against
cv2.decomposeProjectionMatrix; measured 0 on these inputs); scene and
sample cameras 1e-5; images within the resize gap, 1e-5 here (torch's
bicubic/bilinear and Gaussian blur against cv2's; measured at most
3.6e-7 on the fixture's sizes, and 7.2e-6 for a 64x96 -> 50x70 resize).
"""

import os
import zlib
import struct

import imageio.v2 as imageio
import numpy as np
import pytest
import torch

from s_volsdf_tpu.data import fixtures as jfix
from s_volsdf_tpu.data import io as jio
from s_volsdf_tpu.data.mvs_dataset import MVSDataset as JMVSDataset
from s_volsdf_tpu.data.scene_dataset import load_scene as jload_scene
from s_volsdf_tpu.utils.cameras import load_K_Rt_from_P as jdecompose
from s_volsdf_tpu_torch.data import fixtures as tfix
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.data import splits as tsplits
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset as TMVSDataset
from s_volsdf_tpu_torch.data.scene_dataset import load_scene as tload_scene
from s_volsdf_tpu_torch.models.mvs.blocks import interpolate_bilinear
from s_volsdf_tpu_torch.utils.cameras import load_K_Rt_from_P as tdecompose
from s_volsdf_tpu_torch.utils.image import gaussian_blur, resize

IMG_TOL = 1e-5
RES = (64, 96)
TRAIN_IDS = [25, 22, 28]


def _image(shape, seed=0):
    """A smooth ramp plus noise, so rows pick different PNG filters."""
    rng = np.random.default_rng(seed)
    h, w = shape[:2]
    ramp = (np.arange(h)[:, None] * 3 + np.arange(w)[None] * 2) % 256
    ramp = ramp.reshape((h, w) + (1,) * (len(shape) - 2))
    noise = rng.integers(0, 24, size=shape)
    return ((ramp + noise) % 256).astype(np.uint8)


@pytest.mark.parametrize("shape", [(17, 23), (20, 31, 3), (9, 40, 4),
                                   (33, 16, 2)])
def test_png_reader_matches_imageio(tmp_path, shape):
    img = _image(shape)
    path = str(tmp_path / "a.png")
    imageio.imwrite(path, img)
    np.testing.assert_array_equal(tio.read_png(path), imageio.imread(path))


@pytest.mark.parametrize("shape", [(17, 23), (20, 31, 3), (9, 40, 4)])
def test_imageio_reads_port_png(tmp_path, shape):
    img = _image(shape, seed=1)
    path = str(tmp_path / "b.png")
    tio.write_png(path, img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(path)), img)
    np.testing.assert_array_equal(tio.read_png(path), img)


def _filter_row(f, row, prev, bpp):
    """PNG spec section 9 filters, as an encoder applies them."""
    r, p = row.astype(np.int64), prev.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if f == 0:
        pred = np.zeros_like(r)
    elif f == 1:
        pred = a
    elif f == 2:
        pred = p
    elif f == 3:
        pred = (a + p) // 2
    else:
        q = a + p - c
        pa, pb, pc = np.abs(q - a), np.abs(q - p), np.abs(q - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, p, c))
    return ((r - pred) % 256).astype(np.uint8)


def test_png_all_five_filters(tmp_path):
    """Rows filtered with each of the five filter types in turn."""
    img = _image((15, 13, 3), seed=2)
    h, w, ch = img.shape
    flat = img.reshape(h, w * ch)
    raw, prev = [], np.zeros(w * ch, np.uint8)
    for y in range(h):
        f = y % 5
        raw.append(bytes([f]) + _filter_row(f, flat[y], prev, ch).tobytes())
        prev = flat[y]

    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body)))

    path = tmp_path / "f.png"
    path.write_bytes(b"\x89PNG\r\n\x1a\n"
                     + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2,
                                                  0, 0, 0))
                     + chunk(b"IDAT", zlib.compress(b"".join(raw)))
                     + chunk(b"IEND", b""))
    np.testing.assert_array_equal(tio.read_png(str(path)), img)
    np.testing.assert_array_equal(np.asarray(imageio.imread(str(path))), img)


def test_pfm_round_trip(tmp_path):
    arr = np.random.default_rng(3).normal(size=(7, 11)).astype(np.float32)
    tio.save_pfm(str(tmp_path / "a.pfm"), arr)
    jio.save_pfm(str(tmp_path / "b.pfm"), arr)
    assert (tmp_path / "a.pfm").read_bytes() == (tmp_path / "b.pfm").read_bytes()
    for reader in (tio.read_pfm, jio.read_pfm):
        got, scale = reader(str(tmp_path / "a.pfm"))
        np.testing.assert_array_equal(got, arr)
        assert scale == 1.0


def test_cam_file_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    cam = rng.normal(size=(2, 4, 4)).astype(np.float32)
    near_far = np.array([425.0, 2.65, 192, 933.8])
    tio.write_cam(str(tmp_path / "a.txt"), cam, near_far)
    jio.write_cam(str(tmp_path / "b.txt"), cam, near_far)
    assert (tmp_path / "a.txt").read_text() == (tmp_path / "b.txt").read_text()
    K, E = jio.read_camera_parameters(str(tmp_path / "a.txt"))
    np.testing.assert_array_equal(E, cam[0])
    np.testing.assert_array_equal(K, cam[1][:3, :3])


def test_read_camera_parameters_matches_jax(tmp_path):
    cam = np.random.default_rng(6).normal(size=(2, 4, 4)).astype(np.float32)
    tio.write_cam(str(tmp_path / "a.txt"), cam, np.array([425.0, 2.65]))
    for got, want in zip(tio.read_camera_parameters(str(tmp_path / "a.txt")),
                         jio.read_camera_parameters(str(tmp_path / "a.txt"))):
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parts", ["xyz", "rgb", "faces", "rgb_faces",
                                   "empty"])
def test_save_ply_byte_equal(tmp_path, parts):
    """save_ply writes the JAX package's bytes; load_ply (both packages')
    reads them back."""
    rng = np.random.default_rng(7)
    n = 0 if parts == "empty" else 57
    xyz = rng.normal(size=(n, 3)) * 100
    rgb = rng.integers(0, 256, (n, 3)).astype(np.uint8) \
        if "rgb" in parts else None
    faces = rng.integers(0, n, (20, 3)) if "faces" in parts else None
    tio.save_ply(str(tmp_path / "a.ply"), xyz, rgb, faces)
    jio.save_ply(str(tmp_path / "b.ply"), xyz, rgb, faces)
    assert (tmp_path / "a.ply").read_bytes() == (tmp_path / "b.ply").read_bytes()
    for reader in (tio.load_ply, jio.load_ply):
        got_xyz, got_rgb = reader(str(tmp_path / "a.ply"))
        np.testing.assert_array_equal(got_xyz, xyz.astype(np.float32))
        if rgb is None:
            assert got_rgb is None
        else:
            np.testing.assert_array_equal(got_rgb, rgb)


def test_load_ply_ascii(tmp_path):
    path = tmp_path / "a.ply"
    path.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                    "property float x\nproperty float y\nproperty float z\n"
                    "property uchar red\nproperty uchar green\n"
                    "property uchar blue\nend_header\n"
                    "1 2 3 4 5 6\n-1.5 0 2 255 0 7\n")
    for reader in (tio.load_ply, jio.load_ply):
        xyz, rgb = reader(str(path))
        np.testing.assert_array_equal(xyz, [[1, 2, 3], [-1.5, 0, 2]])
        np.testing.assert_array_equal(rgb, [[4, 5, 6], [255, 0, 7]])


def _viz_depth():
    """Every 8-bit level once (a ramp of 256 values from 100 to 355), plus
    NaN, +-inf and masked pixels."""
    depth = np.linspace(100.0, 355.0, 256).reshape(16, 16)
    depth = np.concatenate([depth, np.full((1, 16), 50.0)])
    depth[16, :3] = [np.nan, np.inf, -np.inf]
    mask = np.ones(depth.shape, bool)
    mask[16, 5:8] = False
    return depth.astype(np.float32), mask


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("with_mask,ranged", [(False, True), (True, True),
                                              (True, False)])
def test_visualize_depth_matches_jax(direct, with_mask, ranged):
    from s_volsdf_tpu.utils.viz import visualize_depth as jviz
    from s_volsdf_tpu_torch.utils.viz import visualize_depth as tviz
    depth, mask = _viz_depth()
    kw = dict(mask=mask if with_mask else None, direct=direct)
    if ranged:
        kw.update(depth_min=100.0, depth_max=355.0)
    got, want = tviz(depth, **kw), jviz(depth, **kw)
    assert got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    if ranged and not direct:   # all 256 colours of the table
        assert len(np.unique(got[:16].reshape(-1, 3), axis=0)) == 256


def test_load_K_Rt_from_P_matches_cv2():
    rng = np.random.default_rng(5)
    for _ in range(50):
        # Camera-like and arbitrary projections, either handedness.
        P = rng.normal(size=(3, 4)) * rng.uniform(0.1, 300.0)
        P = P.astype(np.float32)
        (ki, pi), (kj, pj) = tdecompose(P), jdecompose(P)
        np.testing.assert_allclose(ki, kj, atol=1e-5)
        np.testing.assert_allclose(pi, pj, atol=1e-5, rtol=1e-5)


def test_resize_and_blur_gap_vs_cv2():
    """The cubic resize and the blur of the data path, and the runner's
    bilinear resize of the feedback depth (cv2.INTER_LINEAR in the JAX
    runner)."""
    import cv2
    img = np.random.default_rng(6).uniform(size=(64, 96, 3)).astype(np.float32)
    for hw in [(128, 192), (32, 48), (50, 70)]:
        want = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_CUBIC)
        np.testing.assert_allclose(resize(img, hw), want, atol=IMG_TOL)
        want = cv2.resize(img, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)
        got = interpolate_bilinear(torch.tensor(img).permute(2, 0, 1)[None],
                                   hw)[0].permute(1, 2, 0).numpy()
        np.testing.assert_allclose(got, want, atol=IMG_TOL)
    np.testing.assert_allclose(gaussian_blur(img, 31, 90),
                               cv2.GaussianBlur(img, (31, 31), 90),
                               atol=IMG_TOL)


def test_splits_equal():
    from s_volsdf_tpu.data import splits as jsplits
    for name in ("BMVS_SCAN2HASH", "BMVS_NEAR_ID", "_DTU_TRAIN_IDS_ALL",
                 "_DTU_EXCLUDE_IDS", "_BMVS_TRAIN_IDS",
                 "_BMVS_TRAIN_IDS_INTERP", "_BMVS_TEST_IDS"):
        assert getattr(tsplits, name) == getattr(jsplits, name), name
    assert tsplits.get_trains_ids("DTU", "scan106", 3) == TRAIN_IDS
    assert tsplits.get_eval_ids("DTU") == jsplits.get_eval_ids("DTU")


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    """The same DTU fixture written by each package."""
    root = tmp_path_factory.mktemp("fixtures")
    troot, jroot = str(root / "port"), str(root / "jax")
    tfix.make_dtu_fixture(troot, img_res=RES, n_eval_views=2)
    jfix.make_dtu_fixture(jroot, img_res=RES, n_eval_views=2)
    return troot, jroot


def test_dtu_fixture_equal(fixtures):
    troot, jroot = fixtures
    rel = os.path.join("DTU", "scan106")
    ta = np.load(os.path.join(troot, rel, "cameras.npz"))
    ja = np.load(os.path.join(jroot, rel, "cameras.npz"))
    assert sorted(ta.files) == sorted(ja.files)
    for k in ja.files:
        np.testing.assert_array_equal(ta[k], ja[k], err_msg=k)
    names = sorted(os.listdir(os.path.join(jroot, rel, "image")))
    assert sorted(os.listdir(os.path.join(troot, rel, "image"))) == names
    for n in names[::7] + [f"{t:06d}.png" for t in TRAIN_IDS]:
        np.testing.assert_array_equal(
            tio.read_png(os.path.join(troot, rel, "image", n)),
            imageio.imread(os.path.join(jroot, rel, "image", n)))
    mask = os.path.join("DTU", "eval_mask", "scan106", "mask")
    for n in sorted(os.listdir(os.path.join(jroot, mask))):
        np.testing.assert_array_equal(
            tio.read_png(os.path.join(troot, mask, n)),
            imageio.imread(os.path.join(jroot, mask, n)))
    pair = os.path.join("DTU", "mvs_data", "scan106", "pair.txt")
    with open(os.path.join(troot, pair)) as a, \
            open(os.path.join(jroot, pair)) as b:
        assert a.read() == b.read()


def test_load_scene_matches_jax(fixtures):
    _, jroot = fixtures
    t = tload_scene("DTU", RES, 106, 3, jroot)
    j = jload_scene("DTU", RES, 106, 3, jroot)
    np.testing.assert_allclose(t.intrinsics, j.intrinsics, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(t.poses, j.poses, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.rgb, j.rgb)
    np.testing.assert_allclose(t.rgb_smooth, j.rgb_smooth, atol=IMG_TOL)
    assert t.scale_factor == j.scale_factor
    np.testing.assert_array_equal(t.scale_mat, j.scale_mat)
    assert t.trains_ids() == j.trains_ids() == TRAIN_IDS


@pytest.mark.parametrize("x2", [False, True])
def test_mvs_dataset_matches_jax(fixtures, x2):
    """x2_mvsres=True takes the double resize (to 64x96 at base 1, then
    to fit 1152x1536: 1024x1536 here)."""
    _, jroot = fixtures
    kw = dict(datapath=os.path.join(jroot, "DTU", "mvs_data"),
              scan="scan106", nviews=3, data_dir="DTU", ndepths=16,
              interval_scale=1.06, max_h=RES[0], max_w=RES[1],
              trains_i=TRAIN_IDS, data_dir_root=jroot, x2_mvsres=x2)
    tds, jds = TMVSDataset(**kw), JMVSDataset(**kw)
    assert len(tds) == len(jds) == 3
    for i in range(1 if x2 else 3):
        a, b = tds[i], jds[i]
        assert a.view_ids == b.view_ids
        assert a.filename == b.filename
        np.testing.assert_array_equal(a.depth_values, b.depth_values)
        np.testing.assert_array_equal(a.cam_near_far, b.cam_near_far)
        for k in ("stage1", "stage2", "stage3"):
            np.testing.assert_allclose(a.proj_matrices[k],
                                       b.proj_matrices[k],
                                       rtol=1e-5, atol=1e-5, err_msg=k)
        assert a.imgs.shape == b.imgs.shape
        np.testing.assert_allclose(a.imgs, b.imgs, atol=IMG_TOL)
