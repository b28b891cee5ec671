"""The port's mesh export (engine/mesh.py) against the JAX package's.

- `marching_cubes` (csrc/mc.cpp, a copy of native/mc.cpp built with the
  same g++ flags) equals the JAX package's exactly on the same volume.
  The plain numpy version gives the same surface as the C++ core, up to
  its float64 vertex arithmetic where the core's is float32: the same
  number of triangles, matched one to one by their centroids within
  1e-5 voxel with the same orientation, and every vertex within 1e-5
  voxel of the other's (measured 3.9e-6 and 2.7e-6; it merges vertices
  on 6-decimal coordinates, the core on grid edges, and keeps 3,391
  where the core keeps 3,334).
- `triangle_areas`, `largest_component`, `sample_surface`, `slice_box`
  and `eval_geo.mesh_to_pcd` equal the JAX functions exactly.
- `eval_sdf_grid` on the small VolSDF (the plain MLP on the CPU) is
  within 1e-5 of the JAX one on the same points (measured 1.9e-6), and
  the per-launch grid points (`GridPoints`) equal the whole array the
  JAX package builds, with and without the PCA transform.
- `extract_mesh_uniform`, `extract_mesh_high_res` and
  `extract_mesh_by_grid` at resolution 40: fed the JAX SDF's values,
  the port's pipelines give JAX's meshes exactly. With the port's own
  SDF: equal vertex and face counts, and every vertex within 1e-3 of a
  voxel of the other side's nearest (symmetric) on the uniform grids
  (measured 7.6e-5 and 4.2e-4 of a voxel); the PCA-aligned ones within
  PCA_BAR (see there).
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

from s_volsdf_tpu.data.io import save_ply as jsave_ply
from s_volsdf_tpu.engine import eval_geo as jgeo
from s_volsdf_tpu.engine import mesh as jmesh
from s_volsdf_tpu.models.network import sdf_values as jsdf_values
from s_volsdf_tpu_torch.engine import eval_geo as tgeo
from s_volsdf_tpu_torch.engine import mesh as tmesh
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import params_pair, small_configs

RES = 40
BOUNDS = (-1.5, 1.5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _volume(n=32, seed=0):
    """A lumpy sphere: the 0.6 sphere's SDF plus seeded noise."""
    xs = np.linspace(-1.0, 1.0, n)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    vol = np.sqrt(gx ** 2 + gy ** 2 + gz ** 2) - 0.6
    noise = np.random.default_rng(seed).standard_normal(vol.shape) * 0.02
    return (vol + noise).astype(np.float32), xs


def test_marching_cubes_matches_jax():
    vol, xs = _volume()
    spacing = (xs[1] - xs[0],) * 3
    got = tmesh.marching_cubes(vol, 0.0, spacing)
    want = jmesh.marching_cubes(vol, 0.0, spacing)
    assert got[0].shape[0] > 1000
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    empty = tmesh.marching_cubes(np.ones((8, 8, 8), np.float32), 0.0)
    assert empty[0].shape == (0, 3) and empty[1].shape == (0, 3)


def _centroids_normals(verts, faces):
    tri = verts[faces].astype(np.float64)
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    return tri.mean(1), n / np.linalg.norm(n, axis=1, keepdims=True)


def test_numpy_version_matches_native():
    vol, _ = _volume(24, seed=1)
    nv, nf = tmesh.marching_cubes(vol, 0.0)
    pv, pf = tmesh._marching_tetrahedra_numpy(vol, 0.0)
    assert nf.shape[0] == pf.shape[0] > 1000
    for a, b in ((nv, pv), (pv, nv)):
        assert cKDTree(a).query(b)[0].max() <= 1e-5
    cn, nn = _centroids_normals(nv, nf)
    cp, np_ = _centroids_normals(pv, pf)
    dist, idx = cKDTree(cp).query(cn)
    assert dist.max() <= 1e-5 and np.unique(idx).size == idx.size
    assert np.sum(nn * np_[idx], axis=1).min() > 0.999


def _two_spheres():
    xs = np.linspace(-1, 1, 40)
    gx, gy, gz = np.meshgrid(xs, xs, xs, indexing="ij")
    big = np.sqrt((gx + 0.4) ** 2 + gy ** 2 + gz ** 2) - 0.45
    small = np.sqrt((gx - 0.6) ** 2 + gy ** 2 + gz ** 2) - 0.15
    vol = np.minimum(big, small).astype(np.float32)
    verts, faces = tmesh.marching_cubes(vol, 0.0, (xs[1] - xs[0],) * 3)
    return verts + np.float32(xs[0]), faces


def test_mesh_utilities_match_jax(tmp_path):
    verts, faces = _two_spheres()
    np.testing.assert_array_equal(tmesh.triangle_areas(verts, faces),
                                  jmesh.triangle_areas(verts, faces))
    got, want = (tmesh.largest_component(verts, faces),
                 jmesh.largest_component(verts, faces))
    assert got[1].shape[0] < faces.shape[0]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tmesh.sample_surface(verts, faces, 5000),
                                  jmesh.sample_surface(verts, faces, 5000))
    box = (np.array([-0.5, -0.6, -0.3]), np.array([0.7, 0.4, 0.5]))
    for g, w in zip(tmesh.slice_box(verts, faces, *box),
                    jmesh.slice_box(verts, faces, *box)):
        np.testing.assert_array_equal(g, w)
    ply = str(tmp_path / "mesh.ply")
    jsave_ply(ply, verts * 40.0, faces=faces)
    np.testing.assert_array_equal(tgeo.mesh_to_pcd(ply, target_density=0.5),
                                  jgeo.mesh_to_pcd(ply, target_density=0.5))


@pytest.fixture(scope="module")
def sdf_pair():
    """The same small VolSDF in both packages, as their mesh export's SDF
    functions."""
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=2)
    bs = jcfg.model.scene_bounding_sphere
    jfn = lambda pts: jsdf_values(jp["sdf"], jcfg.model, pts, bs)  # noqa: E731
    return jfn, tmesh.mesh_sdf_fn(tp, tcfg.model, bs)


def test_eval_sdf_grid_matches_jax(sdf_pair):
    jfn, tfn = sdf_pair
    pts = np.random.default_rng(4).uniform(-2, 2, (5000, 3)).astype(np.float32)
    want = jmesh.eval_sdf_grid(jfn, pts, chunk=1000)
    builds, sweeps = fused_sdf.pack_sdf.builds, fused_sdf.plain_sweeps
    stats = {}
    got = tmesh.eval_sdf_grid(tfn, pts, chunk=1500, stats=stats)
    assert stats["grids"][0]["launches"] == 4
    # The CPU takes the plain MLP: no pack, plain sweeps counted.
    assert fused_sdf.pack_sdf.builds == builds
    assert fused_sdf.plain_sweeps == sweeps + 4
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_grid_points_match_jax():
    pts, _ = tmesh._grid_from_bounds([-1.5, -1.2, -0.9], [1.5, 1.1, 1.3], 23)
    want, _ = jmesh._grid_from_bounds([-1.5, -1.2, -0.9], [1.5, 1.1, 1.3], 23)
    got = np.concatenate([pts.block(s, min(s + 1000, len(pts)))
                          for s in range(0, len(pts), 1000)])
    np.testing.assert_array_equal(got, want)
    rng = np.random.default_rng(5)
    vecs = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    mean = rng.standard_normal(3)
    pts, _ = tmesh._grid_from_bounds([-1, -1, -1], [1, 1, 1], 23, vecs, mean)
    got = np.concatenate([pts.block(s, min(s + 997, len(pts)))
                          for s in range(0, len(pts), 997)])
    aligned, _ = jmesh._grid_from_bounds([-1, -1, -1], [1, 1, 1], 23)
    np.testing.assert_array_equal(
        got, (aligned @ vecs + mean).astype(np.float32))


def _close_meshes(got, want, voxel, bar=1e-3):
    """Equal vertex and face counts, and every vertex within bar x voxel
    of the other mesh's nearest, both ways; returns that distance."""
    assert got is not None and want is not None
    assert got[0].shape == want[0].shape and got[1].shape == want[1].shape
    d1, _ = cKDTree(want[0]).query(got[0])
    d2, _ = cKDTree(got[0]).query(want[0])
    dist = max(d1.max(), d2.max())
    assert dist <= bar * voxel, (dist, voxel)
    return dist


def _same_mesh(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _on_jax_values(jfn):
    """The JAX package's grid evaluation as the port's SDF function (torch
    in and out), so the two pipelines see the same grid values (each
    grid here is one port launch, so both evaluate it in the same JAX
    chunks)."""
    def fn(pts):
        return torch.from_numpy(jmesh.eval_sdf_grid(jfn, pts.numpy()))
    fn.device = torch.device("cpu")
    return fn


def test_extract_mesh_uniform_matches_jax(sdf_pair):
    jfn, tfn = sdf_pair
    want = jmesh.extract_mesh_uniform(jfn, RES, BOUNDS)
    _same_mesh(tmesh.extract_mesh_uniform(_on_jax_values(jfn), RES, BOUNDS),
               want)
    got = tmesh.extract_mesh_uniform(tfn, RES, BOUNDS)
    _close_meshes(got, want, (BOUNDS[1] - BOUNDS[0]) / (RES - 1))


# The PCA-aligned passes with each package's own SDF: the second grid's
# frame comes from 10,000 area-weighted samples of the first pass's
# surface, which move with the SDFs' 1e-6 differences, and the grid
# moves with them. Equal counts; the vertices within this share of a
# voxel (measured 1.5% for high_res, 3.9% for by_grid at resolution 40).
PCA_BAR = 0.1


def test_extract_mesh_high_res_matches_jax(sdf_pair):
    jfn, tfn = sdf_pair
    stats = {}
    want = jmesh.extract_mesh_high_res(jfn, RES, BOUNDS)
    _same_mesh(tmesh.extract_mesh_high_res(_on_jax_values(jfn), RES, BOUNDS,
                                           stats=stats), want)
    assert [g["points"] for g in stats["grids"]] == [100 ** 3, RES ** 3]
    assert len(stats["marching"]) == 2 and len(stats["component"]) == 1
    got = tmesh.extract_mesh_high_res(tfn, RES, BOUNDS)
    _close_meshes(got, want, (BOUNDS[1] - BOUNDS[0]) / (RES - 1), PCA_BAR)


def test_extract_mesh_by_grid_matches_jax(sdf_pair):
    jfn, tfn = sdf_pair
    box = np.array([[-0.7, -0.6, -0.5], [0.6, 0.7, 0.5]])
    voxel = 2.0 / (RES - 1)
    for higher_res, bar in ((False, 1e-3), (True, PCA_BAR)):
        want = jmesh.extract_mesh_by_grid(box, jfn, RES, higher_res=higher_res)
        _same_mesh(tmesh.extract_mesh_by_grid(box, _on_jax_values(jfn), RES,
                                              higher_res=higher_res), want)
        got = tmesh.extract_mesh_by_grid(box, tfn, RES, higher_res=higher_res)
        _close_meshes(got, want, voxel, bar)
