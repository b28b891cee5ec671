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

Image-based rendering (s_volsdf_tpu/engine/ibr.py) calls cv2's pyrDown,
pyrUp, remap with INTER_CUBIC, erode, subtract and add; their
counterparts (`pyr_down`, `pyr_up`, `remap_cubic`, `erode5`,
`subtract`, `add`) take tensors whose last three dims are (H, W, C) on
any device, keep float64 as float64, and follow OpenCV 5's behaviour
(see `remap_cubic`).
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


# --------------------------------------------------------------------------
# cv2's pyramids, cubic remap and erosion (image-based rendering)
# --------------------------------------------------------------------------

def _reflect101(idx: torch.Tensor, n: int) -> torch.Tensor:
    """cv2.borderInterpolate(i, n, BORDER_REFLECT_101), 1 for n == 1."""
    if n == 1:
        return torch.zeros_like(idx)
    period = 2 * n - 2
    idx = torch.remainder(idx, period)
    return torch.where(idx >= n, period - idx, idx)


def _taps(x: torch.Tensor, dim: int, idx: torch.Tensor) -> torch.Tensor:
    return torch.index_select(x, dim, idx.to(x.device))


def pyr_down(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrDown of (..., H, W, C): the 5-tap [1 4 6 4 1] / 16 filter
    along W, then H, with the BORDER_REFLECT_101 border, keeping every
    other sample: ((H + 1) // 2, (W + 1) // 2). Summed in cv2's order,
    scaled by 1 / 256 at the end."""
    for dim in (-2, -3):
        n = x.shape[dim]
        centre = 2 * torch.arange((n + 1) // 2)
        t = [_taps(x, dim, _reflect101(centre + k, n)) for k in (-2, -1, 0, 1, 2)]
        x = t[2] * 6 + (t[1] + t[3]) * 4 + t[0] + t[4]
    return x * (1.0 / 256)


def pyr_up(x: torch.Tensor) -> torch.Tensor:
    """cv2.pyrUp of (..., H, W, C) to (2H, 2W): even outputs (x[i-1] +
    6 x[i] + x[i+1]) / 8, odd ones (x[i] + x[i+1]) / 2, along W, then
    H. At the near edge x[-1] = x[1] (reflect-101); at the far edge x[n]
    = x[n-1], so the last two outputs are (x[n-2] + 7 x[n-1]) / 8 and
    x[n-1], as cv2 computes them."""
    for dim in (-2, -3):
        n = x.shape[dim]
        i = torch.arange(n)
        prev = _taps(x, dim, torch.where(i > 0, i - 1, min(1, n - 1)))
        nxt = _taps(x, dim, torch.clamp(i + 1, max=n - 1))
        even, odd = prev + x * 6 + nxt, (x + nxt) * 4
        shape = list(x.shape)
        shape[dim] = 2 * n
        x = torch.stack([even, odd], dim=dim).reshape(shape)
    return x * (1.0 / 64)


def _same_size(a: torch.Tensor, b: torch.Tensor, op: str) -> None:
    if a.shape != b.shape:
        raise ValueError(f"cv2.{op}: the arrays' sizes differ "
                         f"({tuple(a.shape)} and {tuple(b.shape)})")


def subtract(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2.subtract of float arrays: a - b, refusing arrays of different
    sizes as cv2 does."""
    _same_size(a, b, "subtract")
    return a - b


def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cv2.add of float arrays: a + b, refusing arrays of different
    sizes as cv2 does."""
    _same_size(a, b, "add")
    return a + b


def _cubic_weights(t: torch.Tensor):
    """cv2's interpolateCubic at fraction t: Keys' kernel with a = -0.75
    at distances 1 + t, t, 1 - t, 2 - t (the last as 1 minus the
    others)."""
    a = -0.75
    w0 = ((a * (t + 1) - 5 * a) * (t + 1) + 8 * a) * (t + 1) - 4 * a
    w1 = ((a + 2) * t - (a + 3)) * t * t + 1
    w2 = ((a + 2) * (1 - t) - (a + 3)) * (1 - t) * (1 - t) + 1
    return w0, w1, w2, 1 - w0 - w1 - w2


def remap_cubic(img: torch.Tensor, map_x: torch.Tensor,
                map_y: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, map_x, map_y, INTER_CUBIC) with the default
    BORDER_CONSTANT of 0, for img (H, W, C) float32 and float32 maps
    (Ho, Wo): the 4x4 taps around each coordinate weighted by Keys'
    cubic (a = -0.75) at the exact coordinate, summed in float64 and
    returned as float32 (Ho, Wo, C). Taps outside the image count as 0,
    so a coordinate up to two pixels outside still reads the edge; NaN
    and coordinates far outside give 0. This is OpenCV 5's remap: 4.x
    rounds float maps to 1/32 pixel first."""
    H, W, C = img.shape
    src = img.to(torch.float64).reshape(H * W, C)
    x, y = map_x.to(torch.float64), map_y.to(torch.float64)
    finite = torch.isfinite(x) & torch.isfinite(y)
    x = torch.where(finite, x, -8.0).clamp(-8.0, W + 8.0)
    y = torch.where(finite, y, -8.0).clamp(-8.0, H + 8.0)
    ix, iy = torch.floor(x), torch.floor(y)
    wx, wy = _cubic_weights(x - ix), _cubic_weights(y - iy)
    ix, iy = ix.to(torch.int64), iy.to(torch.int64)
    out = torch.zeros(x.shape + (C,), dtype=torch.float64, device=img.device)
    for i in range(4):
        yy = iy + (i - 1)
        row = torch.zeros_like(out)
        for j in range(4):
            xx = ix + (j - 1)
            ok = (xx >= 0) & (xx < W) & (yy >= 0) & (yy < H)
            v = src[torch.where(ok, yy * W + xx, 0)]
            row = row + torch.where(ok[..., None], v, 0.0) * wx[j][..., None]
        out = out + row * wy[i][..., None]
    return torch.where(finite[..., None], out, 0.0).to(torch.float32)


def erode5(x: torch.Tensor) -> torch.Tensor:
    """cv2.erode(x, np.ones((5, 5))) of (..., H, W, C) with cv2's default
    border, +max: the minimum over each 5x5 window, pixels outside the
    image never winning. Exact (a minimum of the inputs)."""
    lead = x.shape[:-3]
    H, W, C = x.shape[-3:]
    t = x.reshape(-1, H, W, C).permute(0, 3, 1, 2)
    t = -F.max_pool2d(-t, 5, stride=1, padding=2)
    return t.permute(0, 2, 3, 1).reshape(lead + (H, W, C))
