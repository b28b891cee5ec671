"""MVS-side dataset: pair.txt view graph, cam files, stage projections
(counterpart of s_volsdf_tpu/data/mvs_dataset.py:23-250).

IDR cameras (not the MVS cams) drive the projections; view lists are
re-ordered so source views come from the training set; DTU uses the
fixed 425/2.5x1.06 depth range, BMVS reads per-view cam files with the
scan4/5 far clamp; `x2_mvsres` upscales images to 1152x1536. Host-side
numpy, images NHWC as in the JAX package (the engine moves them to the
device).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from s_volsdf_tpu_torch.data.io import glob_imgs, read_img
from s_volsdf_tpu_torch.data.splits import scan2hash
from s_volsdf_tpu_torch.utils.cameras import load_K_Rt_from_P
from s_volsdf_tpu_torch.utils.image import resize


@dataclass
class MVSSample:
    """One reference view + ordered source views."""
    imgs: np.ndarray               # (V, H, W, 3) float32
    proj_matrices: Dict[str, np.ndarray]  # stage -> (V, 2, 4, 4)
    depth_values: np.ndarray       # (ndepths,)
    cam_near_far: np.ndarray       # (4,)
    filename: str                  # '{scan}/{}/%08d{}' template
    view_ids: List[int]


def read_pair_file(path: str) -> List[Tuple[int, List[int]]]:
    """pair.txt: ref view + scored source views."""
    pairs = []
    with open(path) as f:
        num_viewpoint = int(f.readline())
        for _ in range(num_viewpoint):
            ref_view = int(f.readline().rstrip())
            src_views = [int(x) for x in f.readline().rstrip().split()[1::2]]
            pairs.append((ref_view, src_views))
    return pairs


def read_cam_file(filename: str, ndepths: int, data_dir: str,
                  interval_scale: float):
    """MVS cam txt -> (K/4, extrinsics, depth_min, depth_interval)."""
    with open(filename) as f:
        lines = [line.rstrip() for line in f.readlines()]
    extrinsics = np.array(" ".join(lines[1:5]).split(),
                          np.float32).reshape((4, 4))
    intrinsics = np.array(" ".join(lines[7:10]).split(),
                          np.float32).reshape((3, 3))
    intrinsics[:2, :] /= 4.0
    depth_min = float(lines[11].split()[0])
    depth_interval = float(lines[11].split()[1])

    if data_dir == "BlendedMVS":
        depth_max = float(lines[11].split()[-1])
        depth_interval = (depth_max - depth_min) / ndepths
        return intrinsics, extrinsics, depth_min, depth_interval
    if len(lines[11].split()) >= 3:
        num_depth = lines[11].split()[2]
        depth_max = depth_min + int(float(num_depth)) * depth_interval
        depth_interval = (depth_max - depth_min) / ndepths
    depth_interval *= interval_scale
    return intrinsics, extrinsics, depth_min, depth_interval


def scale_mvs_input(img, intrinsics, max_w, max_h, base=32):
    """Resize (cubic) to fit (max_h, max_w), snapped to `base`."""
    intr = intrinsics.copy()
    h, w = img.shape[:2]
    if h != max_h or w != max_w:
        scale = max_h / h
        if scale * w > max_w:
            scale = max_w / w
        new_w, new_h = scale * w // base * base, scale * h // base * base
    else:
        new_w, new_h = w // base * base, h // base * base
    intr[0, :] *= new_w / w
    intr[1, :] *= new_h / h
    img = resize(img, (int(new_h), int(new_w)))
    return img, intr


class MVSDataset:
    """Per-scene MVS sample builder."""

    def __init__(self, datapath: str, scan: str, nviews: int, data_dir: str,
                 ndepths: int = 192, interval_scale: float = 1.06,
                 max_h: int = 576, max_w: int = 768,
                 trains_i: Optional[List[int]] = None,
                 data_dir_root: str = "", x2_mvsres: bool = True):
        if data_dir not in ("DTU", "BlendedMVS"):
            raise ValueError(f"data_dir={data_dir!r}")
        if data_dir != "DTU" and interval_scale != 1:
            raise ValueError("BlendedMVS requires interval_scale=1")
        if trains_i is None:
            raise ValueError("trains_i is required")
        self.datapath = datapath
        self.scan = scan
        self.nviews = nviews
        self.nviews_max = 5
        self.ndepths = ndepths
        self.data_dir = data_dir
        self.max_h, self.max_w = max_h, max_w
        self.trains_i = trains_i
        self.x2_mvsres = x2_mvsres
        self.interval_scale = interval_scale

        self._meta_from_idr(scan, data_dir, data_dir_root)
        self.metas = self._build_list()

    def _meta_from_idr(self, scan, data_dir, data_dir_root):
        scan_id = scan[4:]
        instance_dir = os.path.join(data_dir_root, data_dir, f"scan{scan_id}")
        image_dir = os.path.join(instance_dir, "image")
        cam_file = os.path.join(instance_dir, "cameras.npz")
        if not os.path.exists(cam_file) and int(scan_id) < 200:
            cam_file = os.path.join(data_dir_root, data_dir, "scan114",
                                    "cameras.npz")
        if not os.path.exists(image_dir):
            raise FileNotFoundError(f"missing {image_dir}")
        if not os.path.exists(cam_file):
            raise FileNotFoundError(f"missing {cam_file}")

        self.image_paths_idr = sorted(glob_imgs(image_dir))
        n_images = len(self.image_paths_idr)
        cams = np.load(cam_file)
        scale_mats = [cams[f"scale_mat_{i}"].astype(np.float32)
                      for i in range(n_images)]
        world_mats = [cams[f"world_mat_{i}"].astype(np.float32)
                      for i in range(n_images)]

        self.intrinsics_idr, self.pose_idr = [], []
        if scan == "scan5" and data_dir == "BlendedMVS":
            # Broken scale_mat: bake it into the cameras.
            for sm, wm in zip(scale_mats, world_mats):
                intr, pose = load_K_Rt_from_P((wm @ sm)[:3, :4])
                self.intrinsics_idr.append(intr)
                self.pose_idr.append(pose)
            self.scale_mat = None
            self.scale_factor = 1.0
            self._scale_mvs = scale_mats[0][0, 0]
        else:
            for wm in world_mats:
                intr, pose = load_K_Rt_from_P(wm[:3, :4])
                self.intrinsics_idr.append(intr)
                self.pose_idr.append(pose)
            self.scale_mat = scale_mats[0]
            self.scale_factor = scale_mats[0][0, 0]

    def _build_list(self):
        scan = self.scan
        if self.data_dir == "DTU":
            pair_file = os.path.join(self.datapath, scan, "pair.txt")
            if not os.path.exists(pair_file):
                pair_file = os.path.join(self.datapath, "scan1", "pair.txt")
        else:
            pair_file = os.path.join(self.datapath, scan2hash(scan), "cams",
                                     "pair.txt")
        if not os.path.exists(pair_file):
            raise FileNotFoundError(pair_file)
        by_ref = {ref: (ref, srcs) for ref, srcs in read_pair_file(pair_file)
                  if len(srcs) > 0 and ref in self.trains_i}
        # Ordered by trains_i.
        return [by_ref[v] for v in self.trains_i]

    def __len__(self):
        return len(self.metas)

    def __getitem__(self, idx: int) -> MVSSample:
        ref_view, src_views = self.metas[idx]
        _srcs = [x for x in src_views if x in self.trains_i]
        view_ids = [ref_view] + _srcs
        view_ids += [x for x in self.trains_i if x not in view_ids]
        view_ids = view_ids[: self.nviews_max]

        imgs, proj_matrices = [], []
        depth_values = cam_near_far = None
        for i, vid in enumerate(view_ids):
            if self.data_dir == "BlendedMVS":
                cam_path = os.path.join(
                    self.datapath, scan2hash(self.scan), "cams",
                    f"{vid:08d}_cam.txt")
                _, _, depth_min, depth_interval = read_cam_file(
                    cam_path, self.ndepths, self.data_dir, 1.0)
                if self.scan == "scan5":
                    depth_min /= self._scale_mvs
                    depth_interval /= self._scale_mvs
                if self.scan in ("scan4", "scan5"):
                    depth_max = depth_min + self.ndepths * depth_interval
                    depth_max = min(depth_max, depth_min * 2.197)
                    depth_interval = (depth_max - depth_min) / self.ndepths
            else:
                depth_min = 425.0
                depth_interval = 2.5 * self.interval_scale

            intrinsics = self.intrinsics_idr[vid][:3, :3].copy()
            intrinsics[:2, :] /= 4.0
            extrinsics = np.linalg.inv(self.pose_idr[vid])

            img = read_img(self.image_paths_idr[vid])
            if self.x2_mvsres:
                img, intrinsics = scale_mvs_input(
                    img, intrinsics, self.max_w, self.max_h, base=1)
                img, intrinsics = scale_mvs_input(img, intrinsics, 1536, 1152)
            else:
                img, intrinsics = scale_mvs_input(
                    img, intrinsics, self.max_w, self.max_h)

            imgs.append(img[..., :3].astype(np.float32))
            proj_mat = np.zeros((2, 4, 4), np.float32)
            proj_mat[0] = extrinsics
            proj_mat[1, :3, :3] = intrinsics
            proj_matrices.append(proj_mat)

            if i == 0:
                depth_values = np.arange(
                    depth_min, depth_interval * (self.ndepths - 0.5)
                    + depth_min, depth_interval, dtype=np.float32)
                cam_near_far = np.array(
                    [depth_min, depth_interval, self.ndepths,
                     depth_interval * self.ndepths + depth_min])

        proj = np.stack(proj_matrices)
        stage2 = proj.copy()
        stage2[:, 1, :2, :] *= 2
        stage3 = proj.copy()
        stage3[:, 1, :2, :] *= 4
        return MVSSample(
            imgs=np.stack(imgs),
            proj_matrices={"stage1": proj, "stage2": stage2,
                           "stage3": stage3},
            depth_values=depth_values,
            cam_near_far=cam_near_far,
            filename=self.scan + "/{}/" + f"{view_ids[0]:08d}" + "{}",
            view_ids=view_ids)
