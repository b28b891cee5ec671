"""The scene that per-scene training and the NVS evaluation read, and
the IDR-format loader (counterpart of
s_volsdf_tpu/data/scene_dataset.py:32-183), with the DTU and the
BlendedMVS eval masks and, for BlendedMVS, each view's nearest training
view (`near_pose`, which the background model's eval renders read).

Host-side numpy: images and cameras are loaded once; the trainer moves
the training views to the device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from s_volsdf_tpu_torch.data.io import glob_imgs, read_image
from s_volsdf_tpu_torch.data.splits import (get_eval_ids, get_near_id,
                                            get_trains_ids)
from s_volsdf_tpu_torch.data.synthetic import SyntheticScene
from s_volsdf_tpu_torch.utils.cameras import load_K_Rt_from_P
from s_volsdf_tpu_torch.utils.image import (gaussian_blur, resize,
                                            resize_nearest)

# DTU scans whose eval views have no foreground masks.
_DTU_NO_MASK = (1, 4, 11, 13, 48)


@dataclass
class SceneData:
    """rgb layouts are (V, H*W, 3) rows, as in the JAX package. A scene
    loaded from disk names its dataset and scan; a synthetic one does
    not, and then every view is a training view and none an eval view.
    masks (V, H*W, 3): 1 on the pixels the NVS metrics count (a DTU
    eval view's foreground mask, a BlendedMVS eval or training view's
    mask alpha, ones elsewhere); None for a synthetic scene."""
    img_res: Tuple[int, int]
    intrinsics: np.ndarray      # (V, 4, 4)
    poses: np.ndarray           # (V, 4, 4) camera-to-world
    rgb: np.ndarray             # (V, H*W, 3)
    rgb_smooth: np.ndarray      # (V, H*W, 3)
    scale_factor: float = 1.0
    data_dir: Optional[str] = None
    scan_id: Optional[int] = None
    num_views: Optional[int] = None
    scale_mat: Optional[np.ndarray] = None
    masks: Optional[np.ndarray] = None

    def trains_ids(self) -> List[int]:
        if self.data_dir is None:
            return list(range(self.rgb.shape[0]))
        return get_trains_ids(self.data_dir, f"scan{self.scan_id}",
                              self.num_views)

    def eval_ids(self) -> List[int]:
        if self.data_dir is None:
            return []
        return get_eval_ids(self.data_dir, self.scan_id)

    def near_pose(self, idx: int) -> Optional[np.ndarray]:
        """The nearest training view's pose, which the BMVS background
        model reads; None for a DTU or synthetic scene."""
        if self.data_dir == "BlendedMVS":
            return self.poses[get_near_id(self.data_dir, self.scan_id, idx)]
        return None


def scene_from_synthetic(scene: SyntheticScene) -> SceneData:
    """Every view of a synthetic scene is a training view; the blurred
    target is the image itself."""
    V = scene.images.shape[0]
    rgb = scene.images.reshape(V, -1, 3)
    return SceneData(img_res=scene.img_res, intrinsics=scene.intrinsics,
                     poses=scene.poses, rgb=rgb, rgb_smooth=rgb,
                     scale_factor=scene.scale_factor)


def _load_rgb(path: str) -> np.ndarray:
    img = read_image(path).astype(np.float32)
    if img.max() > 1.5:
        img = img / 255.0
    return img


def _dtu_mask(root: str, scan_id: int, i: int, img_res) -> Optional[np.ndarray]:
    """The DTU eval mask of view i ((H*W, 3) of 0/1) from
    <root>/scan{id}/mask/{i:03d}.png, else <root>/scan{id}/{i:03d}.png;
    None when neither exists."""
    path = os.path.join(root, f"scan{scan_id}", "mask", f"{i:03d}.png")
    if not os.path.exists(path):
        path = os.path.join(root, f"scan{scan_id}", f"{i:03d}.png")
    if not os.path.exists(path):
        return None
    m = (_load_rgb(path)[..., :3] == 1).astype(np.float32)
    m = resize_nearest(m, img_res)
    return (m > 0.5).astype(np.float32).reshape(-1, 3)


def _bmvs_mask(root: str, scan_id: int, i: int,
               img_res) -> Optional[np.ndarray]:
    """The BlendedMVS mask of view i ((H*W, 3) of 0/1): the alpha of
    the RGBA <root>/scan{id}/mask/{i:08d}.png, nearest-resized, > 0.5;
    None when it does not exist."""
    path = os.path.join(root, f"scan{scan_id}", "mask", f"{i:08d}.png")
    if not os.path.exists(path):
        return None
    m = _load_rgb(path)
    if m.ndim != 3 or m.shape[2] != 4:
        raise ValueError(f"{path}: a BlendedMVS mask is RGBA, got shape "
                         f"{m.shape}")
    m = resize_nearest(np.stack([m[..., -1]] * 3, -1), img_res)
    return (m > 0.5).astype(np.float32).reshape(-1, 3)


def load_scene(data_dir: str, img_res: Tuple[int, int], scan_id: int,
               num_views: int, data_dir_root: str) -> SceneData:
    """Load an IDR-format scene directory: every image, resized to
    img_res (cubic) if needed, its 31x31 sigma-90 blur (the annealed RGB
    target), the cameras decomposed from world_mat @ scale_mat, and the
    masks under <root>/<data_dir>/eval_mask: a DTU eval view's
    foreground, a BlendedMVS eval or training view's alpha."""
    H, W = img_res
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

    image_paths = sorted(glob_imgs(image_dir))
    n_images = len(image_paths)
    cams = np.load(cam_file)
    scale_mats = [cams[f"scale_mat_{i}"].astype(np.float32)
                  for i in range(n_images)]
    world_mats = [cams[f"world_mat_{i}"].astype(np.float32)
                  for i in range(n_images)]

    first = _load_rgb(image_paths[0])
    scale_h = H / first.shape[0]
    scale_w = W / first.shape[1]

    scale_factor = float(scale_mats[0][0, 0])
    if scan_id == 5 and data_dir == "BlendedMVS":
        scale_factor = 1.0      # scan5's scale_mat is wrong; use 1

    mask_root = os.path.join(data_dir_root, data_dir, "eval_mask")
    eval_ids = get_eval_ids(data_dir, scan_id)
    bmvs_ids = eval_ids + get_trains_ids(data_dir, f"scan{scan_id}", 3) \
        if data_dir == "BlendedMVS" else []
    intrinsics_all, poses, rgbs, smooths, masks = [], [], [], [], []
    for i, path in enumerate(image_paths):
        P = (world_mats[i] @ scale_mats[i])[:3, :4]
        intr, pose = load_K_Rt_from_P(P)
        intr[0, :] *= scale_w
        intr[1, :] *= scale_h
        intrinsics_all.append(intr)
        poses.append(pose)

        img = _load_rgb(path)[..., :3]
        if scale_h != 1 or scale_w != 1:
            img = resize(img, (H, W))
        rgbs.append(img.reshape(-1, 3))
        smooths.append(gaussian_blur(img, 31, 90).reshape(-1, 3))
        mask = None
        if data_dir == "DTU" and i in eval_ids \
                and scan_id not in _DTU_NO_MASK:
            mask = _dtu_mask(mask_root, scan_id, i, img_res)
        elif i in bmvs_ids:
            mask = _bmvs_mask(mask_root, scan_id, i, img_res)
        masks.append(np.ones((H * W, 3), np.float32) if mask is None
                     else mask)

    return SceneData(
        img_res=img_res,
        intrinsics=np.stack(intrinsics_all).astype(np.float32),
        poses=np.stack(poses).astype(np.float32),
        rgb=np.stack(rgbs), rgb_smooth=np.stack(smooths),
        scale_factor=scale_factor, data_dir=data_dir, scan_id=scan_id,
        num_views=num_views, scale_mat=scale_mats[0],
        masks=np.stack(masks))
