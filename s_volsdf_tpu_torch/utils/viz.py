"""Depth visualisation (counterpart of s_volsdf_tpu/utils/viz.py:18-44):
the JET-coloured depth and the grey confidence PNGs the scene runner
writes. The port carries cv2's COLORMAP_JET table itself (the card's
machine has no cv2) and returns BGR like the JAX function, so a caller
writes `img[..., ::-1]` with `data.io.write_png` where the JAX package
calls cv2.imwrite.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

# cv2.applyColorMap(arange(256), COLORMAP_JET): 256 BGR triples.
_JET_HEX = (
    "8000008400008800008c00009000009400009800009c0000a00000a40000a80000ac0000"
    "b00000b40000b80000bc0000c00000c40000c80000cc0000d00000d40000d80000dc0000"
    "e00000e40000e80000ec0000f00000f40000f80000fc0000ff0000ff0400ff0800ff0c00"
    "ff1000ff1400ff1800ff1c00ff2000ff2400ff2800ff2c00ff3000ff3400ff3800ff3c00"
    "ff4000ff4400ff4800ff4c00ff5000ff5400ff5800ff5c00ff6000ff6400ff6800ff6c00"
    "ff7000ff7400ff7800ff7c00ff8000ff8400ff8800ff8c00ff9000ff9400ff9800ff9c00"
    "ffa000ffa400ffa800ffac00ffb000ffb400ffb800ffbc00ffc000ffc400ffc800ffcc00"
    "ffd000ffd400ffd800ffdc00ffe000ffe400ffe800ffec00fff000fff400fff800fffc00"
    "feff02faff06f6ff0af2ff0eeeff12eaff16e6ff1ae2ff1edeff22daff26d6ff2ad2ff2e"
    "ceff32caff36c6ff3ac2ff3ebeff42baff46b6ff4ab2ff4eaeff52aaff56a6ff5aa2ff5e"
    "9eff629aff6696ff6a92ff6e8eff728aff7686ff7a82ff7e7eff827aff8676ff8a72ff8e"
    "6eff926aff9666ff9a62ff9e5effa25affa656ffaa52ffae4effb24affb646ffba42ffbe"
    "3effc23affc636ffca32ffce2effd22affd626ffda22ffde1effe21affe616ffea12ffee"
    "0efff20afff606fffa01fffe00fcff00f8ff00f4ff00f0ff00ecff00e8ff00e4ff00e0ff"
    "00dcff00d8ff00d4ff00d0ff00ccff00c8ff00c4ff00c0ff00bcff00b8ff00b4ff00b0ff"
    "00acff00a8ff00a4ff00a0ff009cff0098ff0094ff0090ff008cff0088ff0084ff0080ff"
    "007cff0078ff0074ff0070ff006cff0068ff0064ff0060ff005cff0058ff0054ff0050ff"
    "004cff0048ff0044ff0040ff003cff0038ff0034ff0030ff002cff0028ff0024ff0020ff"
    "001cff0018ff0014ff0010ff000cff0008ff0004ff0000ff0000fc0000f80000f40000f0"
    "0000ec0000e80000e40000e00000dc0000d80000d40000d00000cc0000c80000c40000c0"
    "0000bc0000b80000b40000b00000ac0000a80000a40000a000009c000098000094000090"
    "00008c000088000084000080")
JET_BGR = np.frombuffer(bytes.fromhex(_JET_HEX), np.uint8).reshape(256, 3)


def visualize_depth(depth: np.ndarray, mask: Optional[np.ndarray] = None,
                    depth_min: Optional[float] = None,
                    depth_max: Optional[float] = None,
                    direct: bool = False) -> np.ndarray:
    """JET-coloured depth as BGR uint8 (H, W, 3), near in red, invalid
    (non-finite or outside `mask`) pixels black; with `direct`, the
    scaled value itself as grey uint8 (H, W), invalid pixels 0. The
    range defaults to the 5th and 95th percentiles of the valid pixels."""
    depth = np.array(depth, dtype=np.float64, copy=True)
    invalid = np.isnan(depth) | ~np.isfinite(depth)
    if mask is not None:
        invalid |= ~mask.astype(bool)
    valid = ~invalid
    if depth_min is None:
        depth_min = np.percentile(depth[valid], 5) if valid.any() else 0.0
    if depth_max is None:
        depth_max = np.percentile(depth[valid], 95) if valid.any() else 1.0
    depth = np.clip(depth, depth_min, depth_max)
    depth[invalid] = depth_max

    denom = max(depth_max - depth_min, 1e-12)
    scaled = np.uint8((depth - depth_min) / denom * 255)
    if not direct:
        color = JET_BGR[255 - scaled]
        color[invalid, :] = 0
        return color
    scaled[invalid] = 0
    return scaled
