"""The image resampling the data path needs, in torch (the JAX package
calls cv2 for these): cubic resize with cv2's pixel-centre convention,
and cv2's default-border Gaussian blur. (The runner's linear resize of
the feedback depth is `models.mvs.blocks.interpolate_bilinear`.)

Inputs and outputs are float32 numpy (H, W) or (H, W, C) on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _to_nchw(img: np.ndarray) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(img, np.float32))
    return t[None, None] if t.ndim == 2 else t.permute(2, 0, 1)[None]


def _from_nchw(t: torch.Tensor, ndim: int) -> np.ndarray:
    t = t[0, 0] if ndim == 2 else t[0].permute(1, 2, 0)
    return t.contiguous().numpy()


def resize(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_CUBIC): a = -0.75,
    replicated borders, sampling at pixel centres (align_corners=False).
    A resize to the same size returns a copy."""
    if tuple(img.shape[:2]) == tuple(size_hw):
        return np.array(img, np.float32)
    out = F.interpolate(_to_nchw(img), size=tuple(size_hw), mode="bicubic",
                        align_corners=False)
    return _from_nchw(out, img.ndim)


def gaussian_kernel(ksize: int, sigma: float) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma), in float64."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return k / k.sum()


def gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """cv2.GaussianBlur(img, (ksize, ksize), sigma): separable, with
    cv2's default border (reflect-101, torch's "reflect")."""
    x = _to_nchw(img)
    c = x.shape[1]
    k = torch.as_tensor(gaussian_kernel(ksize, sigma), dtype=torch.float32)
    r = ksize // 2
    x = F.pad(x, (r, r, r, r), mode="reflect")
    x = F.conv2d(x, k.view(1, 1, 1, ksize).expand(c, 1, 1, ksize), groups=c)
    x = F.conv2d(x, k.view(1, 1, ksize, 1).expand(c, 1, ksize, 1), groups=c)
    return _from_nchw(x, img.ndim)
