"""Write a synthetic scene to disk in the DTU or BlendedMVS on-disk
layout (IDR cameras.npz + PNG images, and mvs_data pair.txt or the
BlendedMVS hash directory's cam files), so the whole data path —
scene_dataset, mvs_dataset, runner — reads the formats real data uses
(counterpart of s_volsdf_tpu/data/fixtures.py:18-200).

The files hold the same cameras, pixels and pair lists as the JAX
package's fixture; the PNGs are encoded by the port's own writer.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from s_volsdf_tpu_torch.data.io import write_cam, write_png
from s_volsdf_tpu_torch.data.splits import (get_eval_ids, get_trains_ids,
                                            scan2hash)
from s_volsdf_tpu_torch.data.synthetic import SyntheticScene, make_sphere_scene


def _to_uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _world_mat(c2w: np.ndarray, K: np.ndarray, world_scale: float):
    """K @ w2c of the camera lifted into the scaled world frame."""
    c2w_world = c2w.copy()
    c2w_world[:3, 3] *= world_scale
    w2c = np.linalg.inv(c2w_world)
    world_mat = np.eye(4, dtype=np.float32)
    world_mat[:3, :4] = K[:3, :3] @ w2c[:3, :4]
    return world_mat


def write_idr_scene(root: str, scene: SyntheticScene, scan_id: int = 106,
                    data_dir: str = "DTU", world_scale: float = 200.0,
                    n_pad_views: int = 49) -> str:
    """Write `scene` as <root>/<data_dir>/scan<scan_id>/ in IDR format.

    world_scale maps the unit-sphere scene into a DTU-like metric frame
    (depths land in the hard-coded 425..905 hypothesis range when the
    cameras sit at radius ~2.8): scale_mat = diag(s, s, s, 1),
    world_mat = K @ w2c_world, and P = world_mat @ scale_mat.

    Views beyond the synthetic ones reuse view 0's camera and image, so
    the DTU 49-view id tables resolve.
    """
    inst = os.path.join(root, data_dir, f"scan{scan_id}")
    img_dir = os.path.join(inst, "image")
    os.makedirs(img_dir, exist_ok=True)

    V = scene.poses.shape[0]
    cams = {}
    scale_mat = np.eye(4, dtype=np.float32)
    scale_mat[0, 0] = scale_mat[1, 1] = scale_mat[2, 2] = world_scale
    for i in range(max(n_pad_views, V)):
        v = i if i < V else 0
        cams[f"world_mat_{i}"] = _world_mat(scene.poses[v],
                                            scene.intrinsics[v], world_scale)
        cams[f"scale_mat_{i}"] = scale_mat
        write_png(os.path.join(img_dir, f"{i:06d}.png"),
                  _to_uint8(scene.images[v]))
    np.savez(os.path.join(inst, "cameras.npz"), **cams)
    return inst


def write_pair_file(root: str, scan: str, train_ids: List[int],
                    n_views: int = 49, data_dir: str = "DTU") -> str:
    """Write mvs_data/<scan>/pair.txt listing every view with the other
    training views as its sources (the runner only reads training
    refs)."""
    mvs_dir = os.path.join(root, data_dir, "mvs_data", scan)
    os.makedirs(mvs_dir, exist_ok=True)
    path = os.path.join(mvs_dir, "pair.txt")
    _write_pairs(path, train_ids, n_views)
    return path


def _write_pairs(path: str, train_ids: List[int], n_views: int) -> None:
    """Every view with the other training views as its sources."""
    with open(path, "w") as f:
        f.write(f"{n_views}\n")
        for ref in range(n_views):
            srcs = [t for t in train_ids if t != ref] or train_ids[:2]
            f.write(f"{ref}\n")
            f.write(f"{len(srcs)} " +
                    " ".join(f"{s} {100.0 - i}" for i, s in enumerate(srcs))
                    + "\n")


def write_bmvs_cam_files(root: str, scan: str, scene: SyntheticScene,
                         view_map, world_scale: float,
                         depth_min: float, depth_max: float,
                         n_views: int = 64) -> None:
    """Per-view MVS cam txt files and pair.txt under the scan's BlendedMVS
    hash directory, mvs_data/<hash>/cams/. Line 11 of a cam file is
    'depth_min depth_interval 192 depth_max'."""
    cams_dir = os.path.join(root, "BlendedMVS", "mvs_data", scan2hash(scan),
                            "cams")
    os.makedirs(cams_dir, exist_ok=True)
    interval = (depth_max - depth_min) / 192
    for vid in range(n_views):
        sidx = view_map.get(vid, 0)
        c2w = scene.poses[sidx].copy()
        c2w[:3, 3] *= world_scale
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.linalg.inv(c2w)
        cam[1, :3, :3] = scene.intrinsics[sidx][:3, :3]
        write_cam(os.path.join(cams_dir, f"{vid:08d}_cam.txt"), cam,
                  near_far=np.array([depth_min, interval, 192.0, depth_max]))
    _write_pairs(os.path.join(cams_dir, "pair.txt"), list(view_map.keys()),
                 n_views)


def make_bmvs_fixture(root: str, scan_id: int = 1,
                      img_res: Tuple[int, int] = (64, 96),
                      world_scale: float = 200.0) -> str:
    """BlendedMVS-layout fixture for scan_id: its protocol training ids
    mapped onto 3 distinct synthetic views (cameras at radius 2.8), the
    other ids copies of view 0, and cam files whose depth range is the
    camera distance +- 220."""
    scene = make_sphere_scene(n_views=3, img_res=img_res, cam_radius=2.8)
    train_ids = get_trains_ids("BlendedMVS", f"scan{scan_id}", 3)
    n_views = max(train_ids) + 16
    write_idr_scene(root, scene, scan_id=scan_id, data_dir="BlendedMVS",
                    world_scale=world_scale, n_pad_views=n_views)
    inst = os.path.join(root, "BlendedMVS", f"scan{scan_id}")
    cams = dict(np.load(os.path.join(inst, "cameras.npz")))
    view_map = {}
    for v, tid in enumerate(train_ids):
        view_map[tid] = v
        cams[f"world_mat_{tid}"] = _world_mat(scene.poses[v],
                                              scene.intrinsics[v], world_scale)
        write_png(os.path.join(inst, "image", f"{tid:06d}.png"),
                  _to_uint8(scene.images[v]))
    np.savez(os.path.join(inst, "cameras.npz"), **cams)
    cam_dist = 2.8 * np.sqrt(1 + 0.35 ** 2) * world_scale
    write_bmvs_cam_files(root, f"scan{scan_id}", scene, view_map,
                         world_scale, depth_min=cam_dist - 220,
                         depth_max=cam_dist + 220, n_views=n_views)
    return root


def make_dtu_fixture(root: str, scan_id: int = 106,
                     img_res: Tuple[int, int] = (64, 96),
                     world_scale: float = 200.0,
                     n_eval_views: int = 0) -> str:
    """Full DTU-layout fixture: 49 views (3 distinct), cameras at radius
    2.8 so scaled depths fall inside the DTU 425..905 range.

    n_eval_views > 0 also renders that many distinct held-out views onto
    the first DTU eval ids, with DTU-layout foreground masks under
    eval_mask/; the other padded ids stay copies of view 0."""
    scene = make_sphere_scene(n_views=3 + n_eval_views, img_res=img_res,
                              cam_radius=2.8)
    write_idr_scene(root, scene, scan_id=scan_id, world_scale=world_scale)
    train_ids = [25, 22, 28]
    # Views 0-2 -> train ids, views 3.. -> eval ids.
    inst = os.path.join(root, "DTU", f"scan{scan_id}")
    cams = dict(np.load(os.path.join(inst, "cameras.npz")))
    id_map = list(zip(range(3), train_ids))
    if n_eval_views:
        eval_ids = get_eval_ids("DTU")[:n_eval_views]
        id_map += list(zip(range(3, 3 + n_eval_views), eval_ids))
        mask_dir = os.path.join(root, "DTU", "eval_mask",
                                f"scan{scan_id}", "mask")
        os.makedirs(mask_dir, exist_ok=True)
    for v, tid in id_map:
        cams[f"world_mat_{tid}"] = _world_mat(scene.poses[v],
                                              scene.intrinsics[v], world_scale)
        write_png(os.path.join(inst, "image", f"{tid:06d}.png"),
                  _to_uint8(scene.images[v]))
        if n_eval_views and v >= 3:
            m = (np.isfinite(scene.depths[v])[..., None]
                 * np.ones(3)).astype(np.uint8) * 255
            write_png(os.path.join(mask_dir, f"{tid:03d}.png"), m)
    np.savez(os.path.join(inst, "cameras.npz"), **cams)
    write_pair_file(root, f"scan{scan_id}", train_ids)
    return root
