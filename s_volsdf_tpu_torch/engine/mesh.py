"""Mesh extraction, SDF to triangle mesh (counterpart of
s_volsdf_tpu/engine/mesh.py).

- `marching_cubes`: marching tetrahedra in host C++ (`csrc/mc.cpp`, a
  copy of the JAX package's `native/mc.cpp`, built with g++ at first
  use by `ops/build.py`); a failed build or load raises.
  `_marching_tetrahedra_numpy` is its plain numpy version (the same
  6-tetrahedra split), for the tests.
- `triangle_areas`, `largest_component`, `sample_surface` and
  `slice_box`: numpy, as in the JAX package.
- `eval_sdf_grid`: the SDF of a grid's points in launches of
  `LAUNCH_POINTS` points, each launch's values copied to the host as it
  ends. `mesh_sdf_fn` gives the SDF function the extractors take: the
  sampler's route (`models.network.sampler_sdf_fn`), so on the card the
  fused kernel in the model's mode (one weight pack for the function),
  and the plain MLP on the CPU or for a config outside the kernel's
  family. The kernel takes ragged counts: the tail launch is not padded.
- `extract_mesh_uniform`, `extract_mesh_high_res` (PCA-aligned second
  pass) and `extract_mesh_by_grid`. A grid's points are those of the
  JAX package (float64 `np.linspace`, `meshgrid(indexing="ij")`, the
  float64 PCA transform, then float32), made per launch (`GridPoints`)
  instead of whole: a 512^3 grid is 1.6 GB of float32 points. With a
  `group` (parallel.mesh.eval_group; the JAX package's `mesh=`) each
  launch's points are split over its ranks and the values gathered, so
  every rank holds the whole grid.
"""

from __future__ import annotations

import ctypes
import os
import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.config import ModelConfig
from s_volsdf_tpu_torch.models.network import VolSDFParams, sampler_sdf_fn
from s_volsdf_tpu_torch.ops.build import CSRC_DIR, GXX_FLAGS, build_library, gxx
from s_volsdf_tpu_torch.utils.device import full_float32

MC_SOURCE = os.path.join(CSRC_DIR, "mc.cpp")
# Points per SDF launch of a grid: the size chip_smoke.py times the fused
# kernel at (`KERNEL_RENDER`).
LAUNCH_POINTS = 2_097_152

_LIB = None
_LIB_LOCK = threading.Lock()


class _MCResult(ctypes.Structure):
    _fields_ = [("verts", ctypes.POINTER(ctypes.c_float)),
                ("n_verts", ctypes.c_int64),
                ("tris", ctypes.POINTER(ctypes.c_int64)),
                ("n_tris", ctypes.c_int64)]


def build_mc(force: bool = False) -> str:
    """Compile csrc/mc.cpp into _build/libmc.so unless an up-to-date
    library exists. Raises RuntimeError naming g++ when it cannot."""
    return build_library([gxx()] + GXX_FLAGS, MC_SOURCE, "libmc.so", force)


def _mc_lib():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build_mc())
            lib.mc_run.restype = ctypes.POINTER(_MCResult)
            lib.mc_run.argtypes = [ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_float]
            lib.mc_free.argtypes = [ctypes.POINTER(_MCResult)]
            _LIB = lib
        return _LIB


def marching_cubes(volume: np.ndarray, level: float = 0.0,
                   spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """The `level` isosurface of `volume` (nx, ny, nz): (verts (N, 3)
    float32 in volume coordinates x spacing, faces (M, 3) int64)."""
    vol = np.ascontiguousarray(volume, dtype=np.float32)
    lib = _mc_lib()
    res = lib.mc_run(vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                     *vol.shape, float(level))
    try:
        nv, nt = res.contents.n_verts, res.contents.n_tris
        verts = np.ctypeslib.as_array(res.contents.verts, shape=(nv, 3)).copy() \
            if nv else np.zeros((0, 3), np.float32)
        faces = np.ctypeslib.as_array(res.contents.tris, shape=(nt, 3)).copy() \
            if nt else np.zeros((0, 3), np.int64)
    finally:
        lib.mc_free(res)
    verts = verts * np.asarray(spacing, dtype=np.float32)
    return verts.astype(np.float32), faces.astype(np.int64)


# --------------------------------------------------------------------------
# The plain numpy version (the same 6-tetrahedra split, vectorized)
# --------------------------------------------------------------------------

_TETS = np.array([[0, 5, 1, 3], [0, 5, 3, 7], [0, 5, 7, 4],
                  [0, 3, 2, 7], [0, 2, 6, 7], [0, 4, 7, 6]])
_CASES = {
    1: [(0, 1), (0, 2), (0, 3)], 2: [(1, 0), (1, 3), (1, 2)],
    4: [(2, 0), (2, 1), (2, 3)], 8: [(3, 0), (3, 2), (3, 1)],
    14: [(0, 1), (0, 3), (0, 2)], 13: [(1, 0), (1, 2), (1, 3)],
    11: [(2, 0), (2, 3), (2, 1)], 7: [(3, 0), (3, 1), (3, 2)],
    3: [(0, 2), (0, 3), (1, 2), (1, 2), (0, 3), (1, 3)],
    12: [(0, 2), (1, 2), (0, 3), (1, 2), (1, 3), (0, 3)],
    5: [(0, 1), (2, 1), (0, 3), (2, 1), (2, 3), (0, 3)],
    10: [(0, 1), (0, 3), (2, 1), (2, 1), (0, 3), (2, 3)],
    6: [(1, 0), (2, 0), (1, 3), (2, 0), (2, 3), (1, 3)],
    9: [(1, 0), (1, 3), (2, 0), (2, 0), (1, 3), (2, 3)],
}


def _marching_tetrahedra_numpy(vol: np.ndarray, level: float):
    """(verts, faces) of the isosurface in voxel coordinates; vertices
    merged on their 6-decimal coordinates (so in another order than the
    C++ core's, which merges them on their grid edge)."""
    nx, ny, nz = vol.shape
    corners = np.array([[(c >> 0) & 1, (c >> 1) & 1, (c >> 2) & 1]
                        for c in range(8)])
    xs, ys, zs = np.meshgrid(np.arange(nx - 1), np.arange(ny - 1),
                             np.arange(nz - 1), indexing="ij")
    base = np.stack([xs, ys, zs], axis=-1).reshape(-1, 3)   # (C, 3)
    cvals = np.stack(
        [vol[base[:, 0] + dx, base[:, 1] + dy, base[:, 2] + dz]
         for dx, dy, dz in corners], axis=-1)               # (C, 8)

    tri_pts = []
    for tet in _TETS:
        tv = cvals[:, tet]                                  # (C, 4)
        inside = ((tv < level) * [1, 2, 4, 8]).sum(-1)      # (C,)
        for case, edges in _CASES.items():
            sel = np.nonzero(inside == case)[0]
            if sel.size == 0:
                continue
            pts = []
            for (a, b) in edges:
                pa = base[sel] + corners[tet[a]]
                pb = base[sel] + corners[tet[b]]
                va = tv[sel, a]
                vb = tv[sel, b]
                t = np.where(vb != va, (level - va) /
                             np.where(vb != va, vb - va, 1.0), 0.5)
                t = np.clip(t, 0, 1)[:, None]
                pts.append(pa + t * (pb - pa))
            pts = np.stack(pts, axis=1)                     # (S, 3k, 3)
            tri_pts.append(pts.reshape(-1, 3, 3))
    if not tri_pts:
        return np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int64)
    tris = np.concatenate(tri_pts, axis=0)                  # (T, 3, 3)
    flat = tris.reshape(-1, 3)
    uniq, inv = np.unique(np.round(flat, 6), axis=0, return_inverse=True)
    faces = inv.reshape(-1, 3)
    keep = (faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2]) \
        & (faces[:, 0] != faces[:, 2])
    return uniq.astype(np.float32), faces[keep]


# --------------------------------------------------------------------------
# Mesh utilities
# --------------------------------------------------------------------------

def triangle_areas(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    a = verts[faces[:, 1]] - verts[faces[:, 0]]
    b = verts[faces[:, 2]] - verts[faces[:, 0]]
    return 0.5 * np.linalg.norm(np.cross(a, b), axis=1)


def largest_component(verts: np.ndarray, faces: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """The connected component with the largest surface area (a union-
    find over the faces, in Python as in the JAX package)."""
    if faces.shape[0] == 0:
        return verts, faces
    parent = np.arange(verts.shape[0])

    def find(i):
        root = i
        while parent[root] != root:
            root = parent[root]
        while parent[i] != root:
            parent[i], i = root, parent[i]
        return root

    for f in faces:
        ra, rb, rc = find(f[0]), find(f[1]), find(f[2])
        parent[rb] = ra
        parent[rc] = ra
    roots = np.array([find(i) for i in range(verts.shape[0])])
    areas = triangle_areas(verts, faces)
    face_root = roots[faces[:, 0]]
    best = max(set(face_root.tolist()),
               key=lambda r: areas[face_root == r].sum())
    keep_faces = faces[face_root == best]
    used = np.unique(keep_faces)
    remap = -np.ones(verts.shape[0], np.int64)
    remap[used] = np.arange(used.size)
    return verts[used], remap[keep_faces]


def sample_surface(verts: np.ndarray, faces: np.ndarray, n: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """n points uniform on the surface (area-weighted faces, then a
    uniform point of each), from `rng` (default_rng(0))."""
    rng = rng or np.random.default_rng(0)
    areas = triangle_areas(verts, faces)
    probs = areas / areas.sum()
    idx = rng.choice(faces.shape[0], size=n, p=probs)
    u = rng.random((n, 1))
    v = rng.random((n, 1))
    flip = (u + v) > 1
    u = np.where(flip, 1 - u, u)
    v = np.where(flip, 1 - v, v)
    tri = verts[faces[idx]]
    return tri[:, 0] + u * (tri[:, 1] - tri[:, 0]) \
        + v * (tri[:, 2] - tri[:, 0])


def slice_box(verts: np.ndarray, faces: np.ndarray, box_min, box_max):
    """Drop the faces with any vertex outside the box."""
    inside = np.all((verts >= box_min) & (verts <= box_max), axis=1)
    keep = inside[faces].all(axis=1)
    faces = faces[keep]
    used = np.unique(faces) if faces.size else np.zeros(0, np.int64)
    remap = -np.ones(verts.shape[0], np.int64)
    remap[used] = np.arange(used.size)
    return verts[used], remap[faces]


# --------------------------------------------------------------------------
# SDF grids and the three extraction pipelines
# --------------------------------------------------------------------------

class GridPoints:
    """The float32 points of the grid xs x ys x zs (row-major, "ij"
    order), each mapped by `p @ vecs + mean` in float64 when a transform
    is given, made block by block: `block(s, e)` equals rows s:e of the
    whole array the JAX package builds."""

    def __init__(self, xs, ys, zs, vecs=None, mean=None):
        self.xs, self.ys, self.zs = xs, ys, zs
        self.vecs, self.mean = vecs, mean
        self.shape = (len(xs), len(ys), len(zs))

    def __len__(self) -> int:
        return int(np.prod(self.shape))

    def block(self, start: int, stop: int) -> np.ndarray:
        _, ny, nz = self.shape
        idx = np.arange(start, stop)
        pts = np.stack([self.xs[idx // (ny * nz)], self.ys[idx // nz % ny],
                        self.zs[idx % nz]], axis=-1).astype(np.float32)
        if self.vecs is not None:
            pts = (pts @ self.vecs + self.mean).astype(np.float32)
        return pts


def mesh_sdf_fn(params: VolSDFParams, cfg: ModelConfig,
                bounding_sphere: float) -> Callable:
    """The SDF function of mesh export: the sampler's route and pack
    (`sampler_sdf_fn`), without gradient, in full float32 on the card."""
    fn = sampler_sdf_fn(params, cfg, bounding_sphere)

    def sdf_fn(pts: torch.Tensor) -> torch.Tensor:
        with torch.no_grad(), full_float32():
            return fn(pts)
    sdf_fn.device = params.sdf[0].b.device
    return sdf_fn


def eval_sdf_grid(sdf_fn: Callable, points, chunk: int = LAUNCH_POINTS,
                  stats: Optional[Dict] = None, group=None) -> np.ndarray:
    """SDF values (N,) float32 of `points`, an (N, 3) array or a
    `GridPoints`, in launches of `chunk` points on `sdf_fn.device`, each
    launch's values copied to the host as it ends. With `group`, each
    rank evaluates its rows of a launch's points (`Group.rows`; a launch
    of fewer points than ranks whole on every rank) and the rows are
    gathered. `stats`, when given, gets {"points", "launches",
    "seconds"} appended to its "grids" list (host seconds, which include
    making the points; each copy synchronises; `launches` counts this
    rank's)."""
    device = getattr(sdf_fn, "device", torch.device("cpu"))
    n = len(points)
    out = np.empty(n, np.float32)
    t0 = time.perf_counter()
    launches = 0
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        lo, hi = s, e
        sharded = group is not None and e - s >= group.size
        if sharded:
            a, b = group.rows(e - s)
            lo, hi = s + a, s + b
        block = points.block(lo, hi) if isinstance(points, GridPoints) \
            else np.ascontiguousarray(points[lo:hi], np.float32)
        values = sdf_fn(torch.from_numpy(block).to(device))
        if sharded:
            values = group.gather_rows(values, lo - s, e - s)
        out[s:e] = values.cpu().numpy()
        launches += 1
    if stats is not None:
        stats.setdefault("grids", []).append(
            {"points": n, "launches": launches,
             "seconds": time.perf_counter() - t0})
    return out


def _grid_from_bounds(bmin, bmax, resolution, vecs=None, mean=None):
    xs = np.linspace(bmin[0], bmax[0], resolution)
    ys = np.linspace(bmin[1], bmax[1], resolution)
    zs = np.linspace(bmin[2], bmax[2], resolution)
    return GridPoints(xs, ys, zs, vecs, mean), (xs, ys, zs)


def _timed(stats: Optional[Dict], key: str, fn, *args):
    """fn(*args), its host seconds appended to stats[key] (a list)."""
    t0 = time.perf_counter()
    out = fn(*args)
    if stats is not None:
        stats.setdefault(key, []).append(time.perf_counter() - t0)
    return out


def _surface(z, level, axes, stats):
    """The marching-tetrahedra mesh of the grid values z (R^3) on the
    axes, in the grid's coordinates; None when z does not cross level."""
    if z.min() > level or z.max() < level:
        return None
    xs, ys, zs = axes
    spacing = (xs[1] - xs[0], ys[1] - ys[0], zs[1] - zs[0])
    if stats is not None:
        stats.setdefault("voxel", []).append(float(max(spacing)))
    verts, faces = _timed(stats, "marching", marching_cubes, z, level,
                          spacing)
    return verts + np.array([xs[0], ys[0], zs[0]], np.float32), faces


def extract_mesh_uniform(sdf_fn: Callable, resolution: int = 100,
                         grid_boundary=(-2.0, 2.0), level: float = 0.0,
                         stats: Optional[Dict] = None, group=None):
    """The surface on a uniform resolution^3 grid over the cube
    grid_boundary^3: (verts, faces), or None. `group`: the ranks that
    share the grid's launches (`eval_sdf_grid`), as in the extractors
    below."""
    b0, b1 = grid_boundary
    pts, axes = _grid_from_bounds([b0] * 3, [b1] * 3, resolution)
    z = eval_sdf_grid(sdf_fn, pts, stats=stats, group=group)
    return _surface(z.reshape((resolution,) * 3), level, axes, stats)


def extract_mesh_high_res(sdf_fn: Callable, resolution: int = 512,
                          grid_boundary=(-2.0, 2.0), level: float = 0.0,
                          take_components: bool = True,
                          stats: Optional[Dict] = None, group=None):
    """Two passes: a 100^3 uniform surface, its largest component's
    principal axes (from 10,000 surface samples), then a resolution^3
    grid aligned with them around the surface, 0.1 beyond it. `stats`
    gets each part's host seconds in lists: "grids" (see
    `eval_sdf_grid`), "marching" and "component", in the order they
    ran, and each grid's largest spacing ("voxel")."""
    low = extract_mesh_uniform(sdf_fn, 100, grid_boundary, level,
                               stats=stats, group=group)
    if low is None:
        return None
    verts, faces = low
    if take_components:
        verts, faces = _timed(stats, "component", largest_component,
                              verts, faces)
    pc = sample_surface(verts, faces, 10000)

    mean = pc.mean(axis=0)
    cov = (pc - mean).T @ (pc - mean)
    _, eigvecs = np.linalg.eigh(cov)
    vecs = eigvecs.T[::-1].copy()  # descending eigenvalue order
    if np.linalg.det(vecs) < 0:
        vecs = np.array([[1, 0, 0], [0, 0, 1], [0, 1, 0]],
                        np.float32) @ vecs
    helper = (pc - mean) @ vecs.T

    eps = 0.1
    bmin = helper.min(axis=0) - eps
    bmax = helper.max(axis=0) + eps
    pts_world, axes = _grid_from_bounds(bmin, bmax, resolution, vecs, mean)
    z = eval_sdf_grid(sdf_fn, pts_world, stats=stats, group=group)
    out = _surface(z.reshape((resolution,) * 3), level, axes, stats)
    if out is None:
        return None
    mverts, mfaces = out
    mverts = mverts @ vecs + mean
    return mverts.astype(np.float32), mfaces


def extract_mesh_by_grid(grid_params: np.ndarray, sdf_fn: Callable,
                         resolution: int = 100, level: float = 0.0,
                         higher_res: bool = False,
                         stats: Optional[Dict] = None, group=None):
    """The surface inside a scan's bounding box: grid_params (2, 3)
    [min; max], scaled by [1.5, 1.0] as in the JAX package; with
    higher_res, the two-pass extraction over the box's extent, then the
    faces outside the box dropped."""
    grid_params = grid_params * np.array([[1.5], [1.0]])
    bmin, bmax = grid_params[0], grid_params[1]

    if not higher_res:
        pts, axes = _grid_from_bounds(bmin, bmax, resolution)
        z = eval_sdf_grid(sdf_fn, pts, stats=stats, group=group)
        return _surface(z.reshape((resolution,) * 3), level, axes, stats)

    out = extract_mesh_high_res(sdf_fn, resolution,
                                (float(bmin.min()), float(bmax.max())),
                                level, stats=stats, group=group)
    if out is None:
        return None
    verts, faces = out
    return slice_box(verts, faces, bmin, bmax)
