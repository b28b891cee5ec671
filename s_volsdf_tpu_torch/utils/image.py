"""The image resampling the data path needs, in torch (the JAX package
calls cv2 for these): cubic resize with cv2's pixel-centre convention,
and cv2's default-border Gaussian blur; and for fusion's eval masks
(s_volsdf_tpu/engine/fusion.py:284-291) cv2's elliptic structuring
element, a binary dilation with it and cv2's linear resize. (The
runner's linear resize of the feedback depth is
`models.mvs.blocks.interpolate_bilinear`.)

`resize` and `gaussian_blur` take and return float32 numpy (H, W) or
(H, W, C) on the host; `dilate_binary` and `resize_linear` take and
return (H, W) tensors on any device.
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


def resize_nearest(img: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """cv2.resize(img, (W, H), interpolation=INTER_NEAREST): the source
    pixel floor(i * in / out) on each axis. A resize to the same size
    returns a copy."""
    if tuple(img.shape[:2]) == tuple(size_hw):
        return np.array(img, np.float32)
    out = F.interpolate(_to_nchw(img), size=tuple(size_hw), mode="nearest")
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


def ellipse_kernel(ksize: int) -> np.ndarray:
    """cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (ksize, ksize)) as
    uint8 0/1: row i spans c +- round(c * sqrt(1 - (i - r)^2 / r^2))."""
    r = c = ksize // 2
    inv_r2 = 1.0 / (r * r) if r else 0.0
    k = np.zeros((ksize, ksize), np.uint8)
    for i in range(ksize):
        dy = i - r
        dx = int(np.rint(c * np.sqrt((r * r - dy * dy) * inv_r2)))
        k[i, max(c - dx, 0):min(c + dx + 1, ksize)] = 1
    return k


def dilate_binary(mask: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """cv2.dilate of a 0/1 mask (H, W) with an odd, centred 0/1 kernel
    and cv2's default border (pixels outside the image never win): uint8
    0/1, on the mask's device. A pixel is set when the kernel placed on
    it covers a set pixel; the count of covered set pixels is exact in
    float32."""
    kh, kw = kernel.shape
    if kh % 2 == 0 or kw % 2 == 0:
        raise ValueError(f"dilate_binary: odd kernel sizes only, got "
                         f"{kernel.shape}")
    x = (mask > 0).to(torch.float32)[None, None]
    k = torch.as_tensor(kernel, dtype=torch.float32, device=mask.device)
    hits = F.conv2d(x, k[None, None], padding=(kh // 2, kw // 2))
    return (hits[0, 0] > 0.5).to(torch.uint8)


def _linear_taps(n_in: int, n_out: int):
    """cv2 INTER_LINEAR's taps along one axis: source index, next index
    and the float32 weight of the next, from the pixel-centre map
    (d + 0.5) * n_in / n_out - 0.5, clamped at both ends."""
    f = ((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    f[s < 0] = 0.0
    s[s < 0] = 0
    f[s >= n_in - 1] = 0.0
    s[s >= n_in - 1] = n_in - 1
    return s, np.minimum(s + 1, n_in - 1), f


def resize_linear(img: torch.Tensor, size_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(img, (W, H)) with its default INTER_LINEAR on a float32
    (H, W) tensor, on its device: separable, pixel centres, no
    antialiasing; an exact halving of both sides takes cv2's 2x2 area
    mean instead, as cv2 does. The values are those of cv2's own code
    path; its IPP path differs from it by up to about 1e-4, but not in
    which outputs are zero."""
    img = img.to(torch.float32)
    (h, w), (H, W) = img.shape, size_hw
    if (h, w) == (H, W):
        return img.clone()
    if (h, w) == (2 * H, 2 * W):
        return img.reshape(H, 2, W, 2).sum(dim=(1, 3)) * 0.25
    dev = img.device
    sx, sx1, fx = (torch.as_tensor(a, device=dev) for a in _linear_taps(w, W))
    sy, sy1, fy = (torch.as_tensor(a, device=dev) for a in _linear_taps(h, H))
    rows = img[:, sx] * (1.0 - fx) + img[:, sx1] * fx
    return rows[sy] * (1.0 - fy)[:, None] + rows[sy1] * fy[:, None]
