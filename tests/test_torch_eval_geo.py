"""The port's Chamfer evaluation (engine/eval_geo.py, csrc/downsample.cpp,
cli/eval_dtu.py) against the JAX package's.

Tolerances: the downsample masks bit-equal across the port's C++ core,
its cKDTree plain version and the JAX package's C++ core; acc, comp and
overall within 1e-9 relative (the same scipy queries on the same points;
measured equal); error-cloud PLYs byte-equal.
"""

import os

import numpy as np
import pytest
import scipy.io

from s_volsdf_tpu.data import io as jio
from s_volsdf_tpu.engine import eval_geo as jeval
from s_volsdf_tpu_torch.cli import eval_dtu as tcli_eval
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.engine import eval_geo as teval
from s_volsdf_tpu_torch.ops import build as tbuild

REL = 1e-9


def _cloud(n, seed, radius=160.0, noise=0.5):
    """n points near a sphere of `radius` (the fixture's, in DTU-like
    units), some pairs closer than the downsampling radius."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = d * (radius + noise * rng.standard_normal((n, 1)))
    pts[: n // 10] = pts[n // 10: 2 * (n // 10)] + 0.05 * rng.standard_normal(
        (n // 10, 3))
    return pts.astype(np.float32)


@pytest.mark.parametrize("radius", [0.2, 1.0, 3.0])
def test_downsample_masks_bit_equal(radius):
    pts = _cloud(20000, 0).astype(np.float64)
    native = teval.downsample_mask(pts, radius)
    plain = teval.downsample_mask_plain(pts, radius, chunk=3000)
    np.testing.assert_array_equal(native, plain)
    assert 0 < native.sum() < len(pts)
    rng = np.random.default_rng(4)
    got = teval.downsample_radius(pts, radius, rng=np.random.default_rng(4))
    want = jeval.downsample_radius(pts, radius, rng=rng, native=True)
    np.testing.assert_array_equal(got, want)
    shuffled = pts[np.random.default_rng(0).permutation(len(pts))]
    np.testing.assert_array_equal(
        shuffled[teval.downsample_mask_plain(shuffled, radius)],
        jeval.downsample_radius(pts, radius, native=False))


def test_downsample_empty():
    assert teval.downsample_radius(np.zeros((0, 3), np.float32)).shape == (0, 3)


def test_downsample_build_needs_gxx(monkeypatch):
    """No g++: building the downsampler raises naming g++ (no scipy
    fallback)."""
    monkeypatch.setattr(tbuild.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+"):
        teval.build_downsample(force=True)


def test_downsample_build_failure_raises(monkeypatch, tmp_path):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(teval, "DOWNSAMPLE_SOURCE", str(bad))
    with pytest.raises(RuntimeError, match=r"g\+\+ failed"):
        teval.build_downsample(force=True)


@pytest.mark.parametrize("downsample", [0.0, 0.2, 2.0])
def test_chamfer_matches_jax(downsample):
    pred, gt = _cloud(15000, 1), _cloud(12000, 2, noise=0.0)
    pred[:50] += 40.0     # outliers past max_dist
    got = teval.chamfer(pred, gt, downsample=downsample)
    want = jeval.chamfer(pred, gt, downsample=downsample)
    for k in ("acc", "comp", "overall"):
        assert got[k] == pytest.approx(want[k], rel=REL), k
    assert 0 < got["acc"] < 20 and 0 < got["comp"] < 20


def _write_dtu_gt(root, scan, gt):
    """A synthetic official-DTU layout: ObsMask{scan}_10.mat (a 2 mm
    grid over the cloud's box, observed in its upper half),
    Plane{scan}.mat (z > -100) and the stl cloud."""
    obs = os.path.join(root, "ObsMask")
    os.makedirs(obs, exist_ok=True)
    lo, hi = gt.min(0) - 5, gt.max(0) + 5
    res = 2.0
    shape = tuple(np.ceil((hi - lo) / res).astype(int) + 1)
    mask = np.zeros(shape, np.uint8)
    mask[:, shape[1] // 2:, :] = 1
    scipy.io.savemat(os.path.join(obs, f"ObsMask{scan}_10.mat"),
                     {"ObsMask": mask, "BB": np.stack([lo, hi]),
                      "Res": np.array([[res]])})
    scipy.io.savemat(os.path.join(obs, f"Plane{scan}.mat"),
                     {"P": np.array([[0.0], [0.0], [1.0], [100.0]])})
    tio.save_ply(os.path.join(root, "Points", "stl",
                              f"stl{scan:03d}_total.ply"), gt)


def test_eval_dtu_scan_matches_jax(tmp_path):
    gt = _cloud(10000, 3, noise=0.0)
    pred = _cloud(12000, 4)
    gt_dir, out = str(tmp_path / "dtu"), str(tmp_path / "pred")
    _write_dtu_gt(gt_dir, 106, gt)
    ply = os.path.join(out, "mvsnet106_l3.ply")
    tio.save_ply(ply, pred)
    got = teval.eval_dtu_scan(ply, 106, gt_dir, visualize_error=True,
                              vis_dir=str(tmp_path / "tvis"))
    want = jeval.eval_dtu_scan(ply, 106, gt_dir, visualize_error=True,
                               vis_dir=str(tmp_path / "jvis"))
    for k in ("acc", "comp", "overall"):
        assert got[k] == pytest.approx(want[k], rel=REL), k
    for name in ("vis_106_d2s.ply", "vis_106_s2d.ply"):
        with open(tmp_path / "tvis" / name, "rb") as a, \
                open(tmp_path / "jvis" / name, "rb") as b:
            assert a.read() == b.read(), name
    # The command line on the same files.
    rows = tcli_eval.main(["--datadir", out, "--dataset_dir", gt_dir,
                           "--scan", "106"])
    assert rows == [[got["acc"], got["comp"], got["overall"]]]


def test_eval_bmvs_scan_matches_jax(tmp_path):
    """Scan 1's relative scale; no thinning of the prediction."""
    s = teval.BMVS_RELATIVE_SCALE[1]
    assert teval.BMVS_RELATIVE_SCALE == jeval.BMVS_RELATIVE_SCALE
    gt = _cloud(8000, 5, noise=0.0) * s
    pred = _cloud(9000, 6) * s
    root = str(tmp_path)
    tio.save_ply(os.path.join(root, "BlendedMVS", "stl", "scan1_crop.ply"), gt)
    ply = os.path.join(root, "pred.ply")
    tio.save_ply(ply, pred)
    got = teval.eval_bmvs_scan(ply, 1, root)
    want = jeval.eval_bmvs_scan(ply, 1, root)
    for k in ("acc", "comp", "overall"):
        assert got[k] == pytest.approx(want[k], rel=REL), k


def _sphere_mesh_ply(path, radius=16.0):
    """A marching-tetrahedra sphere of `radius` as a PLY with faces."""
    from s_volsdf_tpu_torch.engine.mesh import marching_cubes
    xs = np.linspace(-20.0, 20.0, 48)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    vol = (np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - radius).astype(np.float32)
    verts, faces = marching_cubes(vol, 0.0, (xs[1] - xs[0],) * 3)
    tio.save_ply(path, verts + np.float32(xs[0]), faces=faces)


@pytest.mark.parametrize("call", ["mesh_mode", "mesh_to_pcd", "save_bmvs_gt"])
def test_mesh_paths_name_their_module(call, tmp_path):
    """The mesh paths run through engine/mesh.py now: a mesh PLY's
    cloud and its DTU Chamfer (function and command line) equal the JAX
    package's; the BMVS GT generator samples a scan's OBJ meshes as the
    JAX one does (tests/test_torch_bmvs_data.py holds it to JAX's on a
    written OBJ) and raises, naming the directory, without them."""
    out = str(tmp_path / "pred")
    ply = os.path.join(out, "mvsnet106_l3.ply")
    if call == "save_bmvs_gt":
        for mod in (teval, jeval):
            with pytest.raises(FileNotFoundError, match="textured_mesh"):
                mod.save_bmvs_gt(1, str(tmp_path), str(tmp_path))
        return
    _sphere_mesh_ply(ply)
    if call == "mesh_to_pcd":
        got = teval.mesh_to_pcd(ply)
        assert got.shape[0] > 10000
        np.testing.assert_array_equal(got, jeval.mesh_to_pcd(ply))
        return
    gt_dir = str(tmp_path / "dtu")
    _write_dtu_gt(gt_dir, 106, _cloud(10000, 3, radius=16.0, noise=0.0))
    got = teval.eval_dtu_scan(ply, 106, gt_dir, mode="mesh")
    want = jeval.eval_dtu_scan(ply, 106, gt_dir, mode="mesh")
    for k in ("acc", "comp", "overall"):
        assert got[k] == pytest.approx(want[k], rel=REL), k
    rows = tcli_eval.main(["--datadir", out, "--dataset_dir", gt_dir,
                           "--scan", "106", "--mode", "mesh"])
    assert rows == [[got["acc"], got["comp"], got["overall"]]]


def test_write_error_clouds_byte_equal(tmp_path):
    pred, gt = _cloud(3000, 7), _cloud(2000, 8, noise=0.0)
    pred[:20] += 50.0
    for mod, name in ((teval, "t"), (jeval, "j")):
        res = mod.chamfer(pred, gt, downsample=0.2, want_detail=True)
        mod.write_error_clouds(res["detail"], str(tmp_path / f"{name}1.ply"),
                               str(tmp_path / f"{name}2.ply"), vis_dist=5.0)
    for k in ("1", "2"):
        assert (tmp_path / f"t{k}.ply").read_bytes() == \
            (tmp_path / f"j{k}.ply").read_bytes()
    xyz, rgb = jio.load_ply(str(tmp_path / "t1.ply"))
    assert rgb is not None and (rgb[:, 1] == 255).any()
