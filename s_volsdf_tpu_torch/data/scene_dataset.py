"""The scene fields that per-scene training reads (the subset of
s_volsdf_tpu/data/scene_dataset.py:SceneData that the port uses)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

import numpy as np

from s_volsdf_tpu_torch.data.synthetic import SyntheticScene


@dataclass
class SceneData:
    """rgb layouts are (V, H*W, 3) rows, as in the JAX package."""
    img_res: Tuple[int, int]
    intrinsics: np.ndarray      # (V, 4, 4)
    poses: np.ndarray           # (V, 4, 4) camera-to-world
    rgb: np.ndarray             # (V, H*W, 3)
    rgb_smooth: np.ndarray      # (V, H*W, 3)
    scale_factor: float = 1.0

    def trains_ids(self) -> List[int]:
        """Every view is a training view."""
        return list(range(self.rgb.shape[0]))


def scene_from_synthetic(scene: SyntheticScene) -> SceneData:
    """Every view of a synthetic scene is a training view; the blurred
    target is the image itself."""
    V = scene.images.shape[0]
    rgb = scene.images.reshape(V, -1, 3)
    return SceneData(img_res=scene.img_res, intrinsics=scene.intrinsics,
                     poses=scene.poses, rgb=rgb, rgb_smooth=rgb,
                     scale_factor=scene.scale_factor)
