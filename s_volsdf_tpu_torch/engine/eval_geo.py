"""Chamfer-distance geometry evaluation, DTU and BlendedMVS protocols
(counterpart of s_volsdf_tpu/engine/eval_geo.py:60-208, 254-286,
339-378). Host code, as in the JAX package: scipy's cKDTree for the
nearest-neighbour queries and a copy of its greedy grid-hash
downsampler (`csrc/downsample.cpp`, sequential by nature).

  * greedy 0.2 mm radius downsampling of the prediction,
  * the DTU ObsMask / bounding-box / ground-plane crops from the
    official .mat files,
  * acc = mean prediction->GT NN distance, comp = mean GT->prediction,
    both without distances of 20 mm or more, overall = (acc + comp) / 2,
  * BMVS: both clouds divided by the scan's `relative_scale`.

A mesh (`mode="mesh"`) is sampled into a cloud first (`mesh_to_pcd`:
its vertices and area-weighted surface samples, engine/mesh.py).
`save_bmvs_gt` makes a BMVS GT cloud from the scan's textured OBJ
meshes.
"""

from __future__ import annotations

import ctypes
import glob
import logging
import os
import re
import threading
from typing import Dict, Optional, Tuple

import numpy as np
from scipy.spatial import cKDTree

from s_volsdf_tpu_torch.data.io import load_ply, read_obj, save_ply
from s_volsdf_tpu_torch.data.splits import scan2hash
from s_volsdf_tpu_torch.engine.mesh import sample_surface, triangle_areas
from s_volsdf_tpu_torch.ops.build import CSRC_DIR, GXX_FLAGS, build_library, gxx

logger = logging.getLogger("s_volsdf_tpu_torch")

DOWNSAMPLE_SOURCE = os.path.join(CSRC_DIR, "downsample.cpp")

# eval_bmvs.py:115
BMVS_RELATIVE_SCALE = {
    1: 0.0010051393651899145, 2: 0.0015733906993148704,
    3: 0.0012326845045689896, 4: 0.0015294108512811993,
    5: 0.007349738091050388, 6: 0.01192223325424887,
    7: 0.001284409757598681, 8: 0.0014762879597404273,
    9: 0.022978406132555827,
}

_DS_LIB = None
_DS_LOCK = threading.Lock()


def build_downsample(force: bool = False) -> str:
    """Compile csrc/downsample.cpp into _build/libdownsample.so unless
    an up-to-date library exists. Raises RuntimeError naming g++ when it
    cannot."""
    return build_library([gxx()] + GXX_FLAGS, DOWNSAMPLE_SOURCE,
                         "libdownsample.so", force)


def _downsample_lib():
    global _DS_LIB
    with _DS_LOCK:
        if _DS_LIB is None:
            lib = ctypes.CDLL(build_downsample())
            lib.radius_downsample.restype = None
            lib.radius_downsample.argtypes = [
                ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
                ctypes.c_double, ctypes.POINTER(ctypes.c_uint8)]
            _DS_LIB = lib
        return _DS_LIB


def downsample_mask_plain(pts: np.ndarray, radius: float,
                          chunk: int = 200_000) -> np.ndarray:
    """The greedy recurrence through cKDTree neighbour lists: keep a
    point iff no kept point before it lies within `radius` (inclusive).
    Streams the queries `chunk` points at a time."""
    n = pts.shape[0]
    tree = cKDTree(pts)
    mask = np.ones(n, dtype=bool)
    for start in range(0, n, chunk):
        neighbors = tree.query_ball_point(pts[start:start + chunk],
                                          r=radius, workers=-1)
        for j, idxs in enumerate(neighbors):
            cur = start + j
            if mask[cur]:
                mask[idxs] = False
                mask[cur] = True
    return mask


def downsample_mask(pts: np.ndarray, radius: float) -> np.ndarray:
    """The same mask from the grid-hash C++ core, on float64 coordinates
    (cKDTree's own promotion, so the distances round alike)."""
    n = pts.shape[0]
    keep = np.zeros(n, dtype=np.uint8)
    if n:
        pts64 = np.ascontiguousarray(pts, dtype=np.float64)
        _downsample_lib().radius_downsample(
            pts64.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_int64(n), ctypes.c_double(radius),
            keep.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return keep.astype(bool)


def downsample_radius(points: np.ndarray, radius: float = 0.2,
                      rng: Optional[np.random.Generator] = None
                      ) -> np.ndarray:
    """Greedy radius downsampling (DTU eval protocol): shuffle with
    `rng` (default seed 0), then keep a point iff no already-kept point
    lies within `radius` (`downsample_mask`, the C++ core: built at
    first use, raising if it cannot be)."""
    rng = rng or np.random.default_rng(0)
    pts = points[rng.permutation(points.shape[0])]
    return pts[downsample_mask(pts, radius)]


def apply_dtu_crops(points: np.ndarray, obsmask_file: str, patch: float = 60
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Official DTU ObsMask + bounding-box crop. Returns (kept points,
    bbox-cropped points, indices of the kept points into `points`)."""
    from scipy.io import loadmat
    m = loadmat(obsmask_file)
    ObsMask, BB, Res = m["ObsMask"], m["BB"].astype(np.float32), m["Res"]
    inbound = (((points >= BB[:1] - patch)
                & (points < BB[1:] + patch * 2)).sum(-1) == 3)
    data_in = points[inbound]
    grid = np.around((data_in - BB[:1]) / Res).astype(np.int32)
    grid_in = (((grid >= 0)
                & (grid < np.expand_dims(ObsMask.shape, 0))).sum(-1) == 3)
    gi = grid[grid_in]
    in_obs = ObsMask[gi[:, 0], gi[:, 1], gi[:, 2]].astype(bool)
    kept_idx = np.where(inbound)[0][grid_in][in_obs]
    return data_in[grid_in][in_obs], data_in, kept_idx


def crop_above_plane(points: np.ndarray, plane_file: str
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Keep GT points above the ground plane. Returns (kept points,
    their indices into `points`)."""
    from scipy.io import loadmat
    P = loadmat(plane_file)["P"]
    hom = np.concatenate([points, np.ones_like(points[:, :1])], -1)
    above = (P.reshape(1, 4) * hom).sum(-1) > 0
    return points[above], np.where(above)[0]


def chamfer(data_pcd: np.ndarray, stl_pcd: np.ndarray, *,
            max_dist: float = 20.0, downsample: float = 0.2,
            patch_size: float = 60.0,
            obsmask_file: Optional[str] = None,
            plane_file: Optional[str] = None,
            want_detail: bool = False) -> Dict:
    """Chamfer (mm): acc = prediction->GT, comp = GT->prediction, each
    the mean of the distances below max_dist (NaN when there are none).
    With `want_detail` the result carries the clouds, the evaluated
    subsets' indices and the NN distances (inf where no neighbour lies
    within max_dist) under "detail" (what `write_error_clouds` needs)."""
    if downsample > 0:
        data_pcd = downsample_radius(data_pcd, downsample)

    if obsmask_file is not None and os.path.exists(obsmask_file):
        data_in_obs, data_in, data_idx = apply_dtu_crops(
            data_pcd, obsmask_file, patch=patch_size)
    else:
        data_in_obs = data_in = data_pcd
        data_idx = np.arange(data_pcd.shape[0])

    stl_eval = stl_pcd
    stl_idx = np.arange(stl_pcd.shape[0])
    if plane_file is not None and os.path.exists(plane_file):
        stl_eval, stl_idx = crop_above_plane(stl_pcd, plane_file)

    # Searches stop at max_dist: a farther neighbour comes back as inf,
    # which the means leave out as they leave out any distance at or
    # past max_dist. (Without the bound, a query far inside a closed
    # surface visits most of the tree.)
    d2s, _ = cKDTree(stl_pcd).query(data_in_obs, k=1, workers=-1,
                                    distance_upper_bound=max_dist)
    acc = float(d2s[d2s < max_dist].mean()) if d2s.size else float("inf")
    s2d, _ = cKDTree(data_in).query(stl_eval, k=1, workers=-1,
                                    distance_upper_bound=max_dist)
    comp = float(s2d[s2d < max_dist].mean()) if s2d.size else float("inf")

    res = {"acc": acc, "comp": comp, "overall": (acc + comp) / 2.0}
    if want_detail:
        res["detail"] = {"data_pcd": data_pcd, "data_idx": data_idx,
                         "d2s": d2s, "stl_pcd": stl_pcd,
                         "stl_idx": stl_idx, "s2d": s2d,
                         "max_dist": max_dist}
    return res


def write_error_clouds(detail: Dict, d2s_path: str, s2d_path: str,
                       vis_dist: float = 10.0) -> None:
    """Error-coloured clouds: evaluated points fade white->red with NN
    distance (clipped at `vis_dist`), points at max_dist or beyond are
    green, points excluded from the statistics stay blue."""

    def colorize(cloud, idx, dist):
        R, G, W = (np.array([c], np.float64) for c in
                   ([1, 0, 0], [0, 1, 0], [1, 1, 1]))
        color = np.tile(np.array([[0, 0, 1.0]]), (cloud.shape[0], 1))
        alpha = (dist.clip(max=vis_dist) / vis_dist)[:, None]
        color[idx] = R * alpha + W * (1 - alpha)
        color[idx[dist >= detail["max_dist"]]] = G
        return (color * 255).astype(np.uint8)

    save_ply(d2s_path, detail["data_pcd"].astype(np.float32),
             rgb=colorize(detail["data_pcd"], detail["data_idx"],
                          detail["d2s"]))
    save_ply(s2d_path, detail["stl_pcd"].astype(np.float32),
             rgb=colorize(detail["stl_pcd"], detail["stl_idx"],
                          detail["s2d"]))
    logger.info(f"error clouds -> {d2s_path}, {s2d_path}")


def mesh_to_pcd(ply_path: str, target_density: float = 0.2,
                max_points: int = 10_000_000) -> np.ndarray:
    """A predicted mesh as a point cloud for the Chamfer evaluation: its
    vertices, then area / target_density^2 surface samples (at most
    max_points; `sample_surface`'s default_rng(0) stream)."""
    verts, faces = _load_mesh(ply_path)
    if faces is None or faces.shape[0] == 0:
        return verts
    area = triangle_areas(verts, faces).sum()
    n = int(min(max_points, max(area / (target_density ** 2), 1)))
    pts = sample_surface(verts, faces, n)
    return np.concatenate([verts, pts.astype(np.float32)], axis=0)


def _load_mesh(ply_path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """(verts (N, 3) float32, faces (M, 3) int32 or None) of a binary
    little-endian PLY as `save_ply` writes it."""
    with open(ply_path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{ply_path}: no end_header")
            header += line
        n_verts = int(re.search(rb"element vertex (\d+)", header).group(1))
        m_face = re.search(rb"element face (\d+)", header)
        vdt = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if b"uchar red" in header:
            vdt += [("r", "u1"), ("g", "u1"), ("b", "u1")]
        rec = np.fromfile(f, dtype=np.dtype(vdt), count=n_verts)
        verts = np.stack([rec["x"], rec["y"], rec["z"]], -1)
        faces = None
        if m_face:
            frec = np.fromfile(f, dtype=np.dtype(
                [("n", "u1"), ("a", "<i4"), ("b", "<i4"), ("c", "<i4")]),
                count=int(m_face.group(1)))
            faces = np.stack([frec["a"], frec["b"], frec["c"]], -1)
    return verts.astype(np.float32), faces


def eval_dtu_scan(pred_ply: str, scan: int, dataset_dir: str,
                  mode: str = "pcd", visualize_error: bool = False,
                  visualize_threshold: float = 10.0,
                  vis_dir: Optional[str] = None, **kwargs
                  ) -> Dict[str, float]:
    """The official DTU protocol for one scan. dataset_dir holds
    ObsMask/ObsMask{scan}_10.mat, ObsMask/Plane{scan}.mat and
    Points/stl/stl{scan:03}_total.ply. visualize_error writes
    vis_{scan:03}_{d2s,s2d}.ply error clouds into vis_dir. mode "mesh"
    samples the predicted mesh first (`mesh_to_pcd`)."""
    if mode == "mesh":
        data_pcd = mesh_to_pcd(pred_ply)
    elif mode == "pcd":
        data_pcd, _ = load_ply(pred_ply)
    else:
        raise ValueError(f"eval_dtu_scan: mode={mode!r}, want 'pcd' or "
                         f"'mesh'")
    stl, _ = load_ply(os.path.join(dataset_dir, "Points", "stl",
                                   f"stl{scan:03d}_total.ply"))
    obsmask = os.path.join(dataset_dir, "ObsMask", f"ObsMask{scan}_10.mat")
    plane_scan = 83 if scan == 82 else scan   # the protocol's plane file
    plane = os.path.join(dataset_dir, "ObsMask", f"Plane{plane_scan}.mat")
    res = chamfer(data_pcd, stl, obsmask_file=obsmask, plane_file=plane,
                  want_detail=visualize_error, **kwargs)
    if visualize_error:
        out = vis_dir or os.path.join(os.path.dirname(pred_ply), "result")
        os.makedirs(out, exist_ok=True)
        write_error_clouds(res.pop("detail"),
                           os.path.join(out, f"vis_{scan:03d}_d2s.ply"),
                           os.path.join(out, f"vis_{scan:03d}_s2d.ply"),
                           vis_dist=visualize_threshold)
    logger.info(f"scan{scan:03d} acc={res['acc']:.2f} "
                f"comp={res['comp']:.2f} overall={res['overall']:.2f}")
    return res


def save_bmvs_gt(scan: int, dataset_dir: str, data_dir_root: str,
                 n_samples: int = 100000,
                 crop_min_z: Optional[float] = None,
                 rng: Optional[np.random.Generator] = None) -> str:
    """The BMVS GT cloud of a scan: every .obj under
    dataset_dir/<scan hash>/textured_mesh/ merged, `n_samples` points
    drawn uniformly by area from `rng` (default_rng(0)), written as
    <data_dir_root>/BlendedMVS/stl/scan{n}.ply. With `crop_min_z`, also
    scan{n}_crop.ply, the points with z >= crop_min_z (the released crops
    cut above the ground plane; the plane is an argument here). Returns
    the path of the last cloud written."""
    gt_dir = os.path.join(dataset_dir, scan2hash(f"scan{scan}"),
                          "textured_mesh")
    obj_files = sorted(glob.glob(os.path.join(gt_dir, "*.obj")))
    if not obj_files:
        raise FileNotFoundError(f"no .obj meshes under {gt_dir}")
    verts_l, faces_l, off = [], [], 0
    for path in obj_files:
        v, t = read_obj(path)
        verts_l.append(v)
        faces_l.append(t + off)
        off += v.shape[0]
    pts = sample_surface(np.concatenate(verts_l), np.concatenate(faces_l),
                         n_samples, rng=rng or np.random.default_rng(0))
    stl_dir = os.path.join(data_dir_root, "BlendedMVS", "stl")
    out = os.path.join(stl_dir, f"scan{scan}.ply")
    save_ply(out, pts.astype(np.float32))
    logger.info(f"bmvs scan{scan}: GT cloud {pts.shape[0]} pts -> {out}")
    if crop_min_z is not None:
        kept = pts[pts[:, 2] >= crop_min_z]
        out = os.path.join(stl_dir, f"scan{scan}_crop.ply")
        save_ply(out, kept.astype(np.float32))
        logger.info(f"bmvs scan{scan}: cropped z>={crop_min_z} "
                    f"{kept.shape[0]} pts -> {out}")
    return out


def eval_bmvs_scan(pred_ply: str, scan: int, data_dir_root: str,
                   no_crop: bool = False, visualize_error: bool = False,
                   vis_dir: Optional[str] = None, **kwargs
                   ) -> Dict[str, float]:
    """The BMVS protocol: both clouds divided by the scan's
    relative_scale (scan 5's prediction first mapped by its
    scale_mat_0), the same Chamfer constants, and no thinning of the
    prediction (`downsample` defaults to 0). visualize_error writes
    {scan}_{d2s,s2d}.ply with vis_dist 10."""
    data_pcd, _ = load_ply(pred_ply)
    if scan == 5:
        cam_file = os.path.join(data_dir_root, "BlendedMVS", "scan5",
                                "cameras.npz")
        scale_mat = np.load(cam_file)["scale_mat_0"]
        hom = np.concatenate([data_pcd, np.ones_like(data_pcd[:, :1])], -1)
        data_pcd = (hom @ scale_mat.T)[:, :3]

    suffix = "" if no_crop else "_crop"
    gt_pcd, _ = load_ply(os.path.join(data_dir_root, "BlendedMVS", "stl",
                                      f"scan{scan}{suffix}.ply"))
    s = BMVS_RELATIVE_SCALE[scan]
    kwargs.setdefault("downsample", 0.0)
    res = chamfer(data_pcd / s, gt_pcd / s, want_detail=visualize_error,
                  **kwargs)
    if visualize_error:
        out = vis_dir or os.path.join(os.path.dirname(pred_ply), "result")
        os.makedirs(out, exist_ok=True)
        write_error_clouds(res.pop("detail"),
                           os.path.join(out, f"{scan}_d2s.ply"),
                           os.path.join(out, f"{scan}_s2d.ply"),
                           vis_dist=10.0)
    logger.info(f"bmvs scan{scan} overall={res['overall']:.2f}")
    return res
