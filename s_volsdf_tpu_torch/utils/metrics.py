"""Image quality metrics: masked PSNR and SSIM (scikit-image's
`structural_similarity` defaults), a copy of
s_volsdf_tpu/utils/metrics.py in numpy and scipy: masked PSNR over the
mask == 1 pixels, SSIM with a 7x7 uniform window, K1 = 0.01, K2 = 0.03,
per channel, then averaged. LPIPS is models/lpips.py.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def masked_psnr(pred: np.ndarray, gt: np.ndarray,
                mask: Optional[np.ndarray] = None) -> float:
    """PSNR over the masked pixels. pred/gt in [0, 1]; mask of the
    same number of elements, 1 on the pixels counted."""
    pred = np.asarray(pred, np.float64).reshape(-1, 3)
    gt = np.asarray(gt, np.float64).reshape(-1, 3)
    if mask is not None:
        m = np.asarray(mask).reshape(-1, 3) == 1
        diff = (pred - gt)[m]
    else:
        diff = pred - gt
    mse = np.mean(diff ** 2)
    return float(-10.0 * np.log10(mse))


def _uniform_filter(x: np.ndarray, size: int) -> np.ndarray:
    """Separable box filter with reflect padding (scipy-compatible)."""
    from scipy.ndimage import uniform_filter
    return uniform_filter(x, size=size, mode="reflect")


def ssim(img1: np.ndarray, img2: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, k1: float = 0.01, k2: float = 0.03) -> float:
    """Structural similarity with scikit-image's defaults (uniform
    window, sample covariance normalisation N/(N-1)). img: (H, W), or
    (H, W, C) with the channels averaged."""
    img1 = np.asarray(img1, np.float64)
    img2 = np.asarray(img2, np.float64)
    if img1.ndim == 3:
        vals = [ssim(img1[..., c], img2[..., c], data_range, win_size,
                     k1, k2) for c in range(img1.shape[-1])]
        return float(np.mean(vals))

    NP = win_size ** 2
    cov_norm = NP / (NP - 1)

    ux = _uniform_filter(img1, win_size)
    uy = _uniform_filter(img2, win_size)
    uxx = _uniform_filter(img1 * img1, win_size)
    uyy = _uniform_filter(img2 * img2, win_size)
    uxy = _uniform_filter(img1 * img2, win_size)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)

    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    a1 = 2 * ux * uy + c1
    a2 = 2 * vxy + c2
    b1 = ux ** 2 + uy ** 2 + c1
    b2 = vx + vy + c2
    s = (a1 * a2) / (b1 * b2)

    # skimage crops the filter boundary (pad = (win_size - 1) // 2).
    pad = (win_size - 1) // 2
    return float(s[pad:-pad, pad:-pad].mean())
