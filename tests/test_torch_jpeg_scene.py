"""JPEG scenes through the port's data path against the JAX package's:
a BlendedMVS fixture whose images are JPEGs, as real scans ship them,
and a fusion directory holding the JAX package's images/*.jpg only.

- Both packages' BMVS fixtures at 64x96 with their images replaced by
  Pillow's JPEGs (4:2:0): `load_scene` rgb bit-equal (the decoder
  equals imageio's), rgb_smooth within the blur gap (1e-5,
  tests/test_torch_data.py), cameras 1e-5; `MVSDataset` depth
  hypotheses and near/far equal, projections 1e-5, images 1e-5.
- The port's own `make_bmvs_fixture(image_format="jpg")` loads, its
  images within 35 dB of the PNG fixture's.
- `load_views` on a directory with images/*.jpg only: the same views as
  the JAX `filter_depth` reads (depths, confidences, cameras, images
  equal); with neither image, an error naming both files.
"""

import os
import shutil

import imageio.v2 as imageio
import numpy as np
import pytest
import torch
from PIL import Image

from s_volsdf_tpu.data import fixtures as jfix
from s_volsdf_tpu.data.mvs_dataset import MVSDataset as JMVSDataset
from s_volsdf_tpu.data.scene_dataset import load_scene as jload_scene
from s_volsdf_tpu.engine import fusion as jfusion
from s_volsdf_tpu_torch.data import fixtures as tfix
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset as TMVSDataset
from s_volsdf_tpu_torch.data.scene_dataset import load_scene as tload_scene
from s_volsdf_tpu_torch.engine import fusion as tfusion
from test_torch_fusion import VIEWS, _sphere_views, write_scene_outputs

RES = (64, 96)
IMG_TOL = 1e-5
CAM_TOL = 1e-5
TRAIN_IDS = [9, 10, 55]     # scan1's
FIXTURE_PSNR = 35.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_pillow_jpegs(image_dir):
    """Replace every PNG of the directory by Pillow's JPEG (quality 90,
    4:2:0) of its pixels, under the same stem."""
    for name in sorted(os.listdir(image_dir)):
        png = os.path.join(image_dir, name)
        Image.fromarray(tio.read_png(png)).save(
            png[:-4] + ".jpg", "JPEG", quality=90, subsampling=2)
        os.remove(png)


@pytest.fixture(scope="module")
def jpeg_fixtures(tmp_path_factory):
    root = tmp_path_factory.mktemp("bmvs_jpeg")
    troot, jroot = str(root / "port"), str(root / "jax")
    tfix.make_bmvs_fixture(troot, scan_id=1, img_res=RES)
    jfix.make_bmvs_fixture(jroot, scan_id=1, img_res=RES)
    for r in (troot, jroot):
        _to_pillow_jpegs(os.path.join(r, "BlendedMVS", "scan1", "image"))
    return troot, jroot


def test_load_scene_of_jpegs_matches_jax(jpeg_fixtures):
    troot, jroot = jpeg_fixtures
    image_dir = os.path.join("BlendedMVS", "scan1", "image")
    names = sorted(os.listdir(os.path.join(jroot, image_dir)))
    assert names and all(n.endswith(".jpg") for n in names)
    for n in names[::10]:
        with open(os.path.join(troot, image_dir, n), "rb") as a, \
                open(os.path.join(jroot, image_dir, n), "rb") as b:
            assert a.read() == b.read(), n
    t = tload_scene("BlendedMVS", RES, 1, 3, troot)
    j = jload_scene("BlendedMVS", RES, 1, 3, jroot)
    np.testing.assert_array_equal(t.rgb, j.rgb)
    np.testing.assert_allclose(t.rgb_smooth, j.rgb_smooth, atol=IMG_TOL)
    np.testing.assert_allclose(t.intrinsics, j.intrinsics, rtol=CAM_TOL,
                               atol=CAM_TOL)
    np.testing.assert_allclose(t.poses, j.poses, rtol=CAM_TOL, atol=CAM_TOL)
    assert t.trains_ids() == j.trains_ids() == TRAIN_IDS


def test_mvs_dataset_of_jpegs_matches_jax(jpeg_fixtures):
    troot, jroot = jpeg_fixtures
    kw = dict(scan="scan1", nviews=3, data_dir="BlendedMVS", ndepths=16,
              interval_scale=1.0, max_h=RES[0], max_w=RES[1],
              trains_i=TRAIN_IDS, x2_mvsres=False)
    tds = TMVSDataset(datapath=os.path.join(troot, "BlendedMVS", "mvs_data"),
                      data_dir_root=troot, **kw)
    jds = JMVSDataset(datapath=os.path.join(jroot, "BlendedMVS", "mvs_data"),
                      data_dir_root=jroot, **kw)
    assert len(tds) == len(jds) == 3
    for i in range(3):
        a, b = tds[i], jds[i]
        assert a.view_ids == b.view_ids and a.filename == b.filename
        np.testing.assert_array_equal(a.depth_values, b.depth_values)
        np.testing.assert_array_equal(a.cam_near_far, b.cam_near_far)
        for k in ("stage1", "stage2", "stage3"):
            np.testing.assert_allclose(a.proj_matrices[k], b.proj_matrices[k],
                                       rtol=CAM_TOL, atol=CAM_TOL, err_msg=k)
        np.testing.assert_allclose(a.imgs, b.imgs, atol=IMG_TOL)


def test_port_jpeg_fixture_loads(tmp_path):
    """make_bmvs_fixture(image_format="jpg"): JPEG images only, which
    load_scene reads as imageio does, close to the PNG fixture's."""
    jpg, png = str(tmp_path / "jpg"), str(tmp_path / "png")
    tfix.make_bmvs_fixture(jpg, scan_id=1, img_res=RES, image_format="jpg")
    tfix.make_bmvs_fixture(png, scan_id=1, img_res=RES)
    image_dir = os.path.join(jpg, "BlendedMVS", "scan1", "image")
    names = sorted(os.listdir(image_dir))
    assert len(names) == max(TRAIN_IDS) + 16
    assert all(n.endswith(".jpg") for n in names)
    t = tload_scene("BlendedMVS", RES, 1, 3, jpg)
    p = tload_scene("BlendedMVS", RES, 1, 3, png)
    for vid in TRAIN_IDS:
        want = imageio.imread(os.path.join(image_dir, f"{vid:06d}.jpg"))
        np.testing.assert_array_equal(
            t.rgb[vid], want.reshape(-1, 3).astype(np.float32) / 255.0)
        psnr = -10 * np.log10(np.mean((t.rgb[vid] - p.rgb[vid]) ** 2))
        assert psnr > FIXTURE_PSNR, (vid, psnr)
    np.testing.assert_array_equal(t.intrinsics, p.intrinsics)
    with pytest.raises(ValueError, match="image_format"):
        tfix.make_bmvs_fixture(str(tmp_path / "x"), img_res=RES,
                               image_format="bmp")


def test_load_views_reads_jax_jpegs(tmp_path, monkeypatch):
    """A directory with the JAX package's images/*.jpg only: the port's
    load_views reads the same views as the JAX filter_depth."""
    _, views = _sphere_views()
    root = str(tmp_path)
    write_scene_outputs(root, views)
    for v in VIEWS:
        os.remove(os.path.join(root, f"images/{v:08d}.png"))
    seen = []
    monkeypatch.setattr(jfusion, "fuse_views",
                        lambda v, **kw: seen.append(v) or (
                            np.zeros((0, 3), np.float32),
                            np.zeros((0, 3), np.uint8), []))
    jfusion.filter_depth(root, root, str(tmp_path / "x.ply"), VIEWS)
    got, masks = tfusion.load_views(root, root, VIEWS, device="cpu")
    assert masks == [None] * len(VIEWS)
    for g, w in zip(got, seen[0]):
        assert sorted(g) == sorted(w)
        for k in w:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_load_views_names_both_images(tmp_path):
    _, views = _sphere_views((16, 24))
    write_scene_outputs(str(tmp_path), views)
    for ext in ("png", "jpg"):
        os.remove(tmp_path / f"images/{VIEWS[1]:08d}.{ext}")
    with pytest.raises(FileNotFoundError) as exc:
        tfusion.load_views(str(tmp_path), str(tmp_path), VIEWS, device="cpu")
    assert f"{VIEWS[1]:08d}.png" in str(exc.value)
    assert f"{VIEWS[1]:08d}.jpg" in str(exc.value)
    shutil.rmtree(tmp_path / "images")
