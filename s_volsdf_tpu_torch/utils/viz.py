"""Depth visualisation (counterpart of s_volsdf_tpu/utils/viz.py):
the JET-coloured depth and the grey confidence PNGs the scene runner
writes, and the trainer's plot panel (`stacked_panel`, TURBO depth).
The port carries cv2's COLORMAP_JET and COLORMAP_TURBO tables itself
(the card's machine has no cv2) and returns BGR like the JAX function,
so a caller writes `img[..., ::-1]` with `data.io.write_png` where the
JAX package calls cv2.imwrite.
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
# cv2.applyColorMap(arange(256), COLORMAP_TURBO): 256 BGR triples.
_TURBO_HEX = (
    "3b12304315324a1833511b34581e355f21366624376d2738732a39792d3a802f3b86323c"
    "8b353d91383e973b3f9c3e3fa24040a74341ac4641b14942b54b42ba4e43bf5144c35444"
    "c75644cb5945cf5c45d35e45d66146da6446dd6646e06946e36b46e66e47e97147eb7347"
    "ee7647f07847f27b47f47d46f68046f88246fa8546fb8746fc8a45fd8c45fe8f44fe9143"
    "ff9442ff9641ff9940fe9b3efe9e3dfda03bfca33afba538faa837f8ab35f7ad33f5af31"
    "f4b22ff2b42ef0b72ceeb92aebbc28e9be27e7c025e4c323e2c522dfc720ddc91fdacb1e"
    "d8cd1cd5d01bd2d21ad0d41acdd519cad718c8d918c5db18c2dd18c0de18bde018bbe219"
    "b9e319b6e41ab4e61cb2e71dafe91facea20aaeb22a7ec25a4ee27a1ef2a9ef02c9bf12f"
    "98f23294f33591f4388ef53c8af63f87f74384f84680f84a7df94e7afa5276fa5573fb59"
    "6ffc5d6cfc6169fd6566fd6962fe6d5ffe715cfe7559fe7956ff7d53ff8051ff844eff88"
    "4bff8b49ff8f47ff9244fe9642fe9940fe9c3ffd9f3dfda13cfca43afca739fba938fbac"
    "37faaf36f9b136f8b435f7b735f6b934f5bc34f4be34f3c134f1c334f0c634efc834edcb"
    "34eccd34ead035e9d235e7d435e5d736e4d936e2db37e0dd37dfdf37dde138dbe338d9e5"
    "39d7e739d5e939d3eb3ad1ec3acfee3acdef3acbf13ac9f23ac7f43ac5f53ac3f63ac1f7"
    "39bef839bcf939bafa38b8fb37b6fb36b3fc36b1fc35aefd34acfd33a9fe32a7fe31a4fe"
    "30a1fe2f9efe2d9bfe2c99fe2b96fe2a93fe2990fe278dfd268afd2587fc2384fc2281fb"
    "217efb1f7bfa1e78f91d75f91c72f81a6ff7196cf61869f51766f41563f31460f2135df1"
    "125bf01158ef1055ed0f53ec0e50eb0d4eea0c4be80c49e70b47e50a45e40a43e20941e1"
    "083fdf083ddd073bdc0739da0637d80635d60533d40531d2052fd0042dce042bcc042aca"
    "0328c80326c50325c30223c10221be0220bc021eb9021db7011bb4011ab20118af0117ac"
    "0116a90114a70113a40112a101109e010f9b010e98010d95010b92010a8e02098b020888"
    "02078502068102057e03047a")
TURBO_BGR = np.frombuffer(bytes.fromhex(_TURBO_HEX), np.uint8).reshape(256, 3)


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


def depth_panel(depth: np.ndarray, acc: np.ndarray,
                acc_thresh: float = 0.2) -> np.ndarray:
    """TURBO-coloured depth masked by accumulation, RGB float in [0, 1],
    the range the 2nd and 98th percentiles of the pixels with acc >=
    acc_thresh."""
    d = np.array(depth, dtype=np.float64, copy=True)
    valid = acc >= acc_thresh
    if valid.any():
        lo, hi = np.percentile(d[valid], [2, 98])
    else:
        lo, hi = d.min(), d.max()
    d = np.clip((d - lo) / max(hi - lo, 1e-12), 0, 1)
    bgr = TURBO_BGR[np.uint8((1 - d) * 255)]
    rgb = bgr[..., ::-1].astype(np.float32) / 255.0
    rgb[~valid] = 0.0
    return rgb


def stacked_panel(rgb_gt: np.ndarray, rgb: np.ndarray, depth: np.ndarray,
                  normal: np.ndarray, acc: np.ndarray) -> np.ndarray:
    """[GT | render | depth | normal] strip, RGB float (H, 4W, 3)."""
    dep = depth_panel(depth, acc)
    nrm = np.clip((normal + 1.0) / 2.0, 0, 1)
    return np.concatenate(
        [np.clip(rgb_gt, 0, 1), np.clip(rgb, 0, 1), dep, nrm], axis=1)
