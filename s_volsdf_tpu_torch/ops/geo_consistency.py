"""Geometric consistency of a (reference, source) pair of depth maps:
the CUDA kernel `csrc/fusion.cu` and its plain PyTorch version
(counterpart of s_volsdf_tpu/native/fusion.cpp:59-105, the host core of
s_volsdf_tpu/engine/fusion.py's `check_geometric_consistency`).

For every reference pixel: lift its depth, move it into the source
camera and project it, sample the source depth bilinearly there (a
corner outside the image contributes 0), lift that back into the
reference camera and project it; the pixel passes if it came back
within `filter_dist` pixels with a relative depth difference below
`filter_diff`. All in float64, in the host C++'s order of operations.

Dispatch is by the device of the depth maps alone. CPU tensors go
through `geo_consistency_plain`; CUDA tensors launch the kernel or
raise. There is no fallback from the kernel to the plain version.

The kernel library is built with nvcc (`--fmad=false`) at first use
into `_build/` and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.ops.build import (CSRC_DIR, NVCC_FLAGS,
                                          build_library, nvcc)

SOURCE = os.path.join(CSRC_DIR, "fusion.cu")
# Every product and sum rounds on its own, as in the host C++ and the
# plain version: the masks can then be held equal.
FLAGS = NVCC_FLAGS + ["--fmad=false"]

# The pair's camera algebra, in the kernel's `struct GeoMats` order.
MAT_FIELDS = (("invK_ref", 9), ("K_src", 9), ("invK_src", 9), ("K_ref", 9),
              ("R_rs", 9), ("t_rs", 3), ("R_sr", 9), ("t_sr", 3))


class GeoMats(ctypes.Structure):
    """Mirror of `struct GeoMats` in csrc/fusion.cu (passed by value)."""
    _fields_ = [(name, ctypes.c_double * n) for name, n in MAT_FIELDS]


def pair_matrices(intr_ref: np.ndarray, extr_ref: np.ndarray,
                  intr_src: np.ndarray, extr_src: np.ndarray
                  ) -> Dict[str, np.ndarray]:
    """The matrices the check applies, flat float64 row-major, computed
    as s_volsdf_tpu/engine/fusion.py:_geo_consistency_native does: with
    numpy in the cameras' own dtype (float32 from the cam files), then
    cast."""
    t_rs = extr_src @ np.linalg.inv(extr_ref)   # ref cam -> src cam
    t_sr = extr_ref @ np.linalg.inv(extr_src)
    mats = {"invK_ref": np.linalg.inv(intr_ref[:3, :3]),
            "K_src": intr_src[:3, :3],
            "invK_src": np.linalg.inv(intr_src[:3, :3]),
            "K_ref": intr_ref[:3, :3],
            "R_rs": t_rs[:3, :3], "t_rs": t_rs[:3, 3],
            "R_sr": t_sr[:3, :3], "t_sr": t_sr[:3, 3]}
    return {k: np.ascontiguousarray(v, dtype=np.float64).reshape(-1)
            for k, v in mats.items()}


def _mat3v(m: np.ndarray, a, b, c):
    return [float(m[3 * r]) * a + float(m[3 * r + 1]) * b
            + float(m[3 * r + 2]) * c for r in range(3)]


def _bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img (H, W) float64 at float coordinates; a corner outside the
    image contributes 0 (the corner tests are on the doubles, as in the
    kernel)."""
    H, W = img.shape
    flat = img.reshape(-1)
    fx, fy = torch.floor(x), torch.floor(y)
    wx, wy = x - fx, y - fy
    v = torch.zeros_like(x)
    for dx, dy, w in ((0, 0, (1.0 - wx) * (1.0 - wy)),
                      (1, 0, wx * (1.0 - wy)),
                      (0, 1, (1.0 - wx) * wy),
                      (1, 1, wx * wy)):
        cx, cy = fx + dx, fy + dy
        ok = (cx >= 0) & (cx < W) & (cy >= 0) & (cy < H)
        idx = torch.where(ok, cy * W + cx, 0.0).to(torch.int64)
        v = v + torch.where(ok, flat[idx] * w, 0.0)
    return v


def _pixel_grid(H: int, W: int, device):
    y = torch.arange(H, dtype=torch.float64, device=device)[:, None]
    x = torch.arange(W, dtype=torch.float64, device=device)[None, :]
    return x.expand(H, W), y.expand(H, W)


def reproject_plain(depth_ref: torch.Tensor, depth_src: torch.Tensor,
                    mats: Dict[str, np.ndarray]):
    """The round trip of every reference pixel, float64, in the host
    C++'s order: (reprojected depth, x and y back in the reference,
    source x and y). Depths (H, W) of any float dtype, one device."""
    H, W = depth_ref.shape
    d = depth_ref.to(torch.float64)
    x, y = _pixel_grid(H, W, d.device)
    pr = _mat3v(mats["invK_ref"], x * d, y * d, d)
    ps = _mat3v(mats["R_rs"], *pr)
    ps = [ps[i] + float(mats["t_rs"][i]) for i in range(3)]
    k = _mat3v(mats["K_src"], *ps)
    z = torch.where(k[2] > 1e-12, k[2], 1e-12)
    xs, ys = k[0] / z, k[1] / z
    sampled = _bilinear(depth_src.to(torch.float64), xs, ys)
    ps2 = _mat3v(mats["invK_src"], xs * sampled, ys * sampled, sampled)
    pr2 = _mat3v(mats["R_sr"], *ps2)
    pr2 = [pr2[i] + float(mats["t_sr"][i]) for i in range(3)]
    k = _mat3v(mats["K_ref"], *pr2)
    z2 = torch.where(k[2] > 1e-12, k[2], 1e-12)
    return pr2[2], k[0] / z2, k[1] / z2, xs, ys


Result = Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor],
               Optional[torch.Tensor]]


def geo_consistency_plain(depth_ref: torch.Tensor, depth_src: torch.Tensor,
                          mats: Dict[str, np.ndarray], filter_dist: float,
                          filter_diff: float, xy: bool = False) -> Result:
    """What the kernel computes, as torch float64 ops: (mask bool,
    reprojected depth float64, 0 where the mask fails, and with `xy`
    the source x and y float64, else None and None)."""
    depth_reproj, x2, y2, xs, ys = reproject_plain(depth_ref, depth_src,
                                                   mats)
    d = depth_ref.to(torch.float64)
    x, y = _pixel_grid(*d.shape, d.device)
    dist = torch.sqrt((x2 - x) * (x2 - x) + (y2 - y) * (y2 - y))
    dref = torch.where(d > 1e-12, d, 1e-12)
    rel = torch.abs(depth_reproj - d) / dref
    ok = (dist < filter_dist) & (rel < filter_diff)
    depth_out = torch.where(ok, depth_reproj, 0.0)
    return (ok, depth_out) + ((xs, ys) if xy else (None, None))


_LIB = None
_LIB_LOCK = threading.Lock()


def build(force: bool = False) -> str:
    """Compile csrc/fusion.cu into _build/libgeo_consistency.so unless an
    up-to-date library exists. Raises RuntimeError naming nvcc when it
    cannot."""
    return build_library([nvcc()] + FLAGS, SOURCE, "libgeo_consistency.so",
                         force)


def bind(path: str):
    """Load a build of csrc/fusion.cu and declare its C entry points."""
    lib = ctypes.CDLL(path)
    vp = ctypes.c_void_p
    lib.geo_consistency_launch.argtypes = [
        vp, vp, ctypes.c_int, ctypes.c_int, GeoMats, ctypes.c_double,
        ctypes.c_double, vp, vp, vp, vp, vp]
    lib.geo_consistency_launch.restype = ctypes.c_int
    lib.geo_consistency_error_string.argtypes = [ctypes.c_int]
    lib.geo_consistency_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = bind(build())
        return _LIB


def geo_consistency(depth_ref: torch.Tensor, depth_src: torch.Tensor,
                    mats: Dict[str, np.ndarray], filter_dist: float,
                    filter_diff: float, xy: bool = False) -> Result:
    """The check of one pair: (mask bool, reprojected depth float64, 0
    where the mask fails, and with `xy` the source x and y float64).

    CPU tensors: `geo_consistency_plain`. CUDA tensors: one launch of
    the kernel on the current stream (counted in
    `geo_consistency.launches`), which takes (H, W) contiguous float32
    depths of one shape, or an exception."""
    if depth_ref.device.type == "cpu" and depth_src.device.type == "cpu":
        return geo_consistency_plain(depth_ref, depth_src, mats,
                                     filter_dist, filter_diff, xy)
    if depth_ref.device.type != "cuda" or depth_src.device != depth_ref.device:
        raise ValueError(f"geo_consistency: depths on {depth_ref.device} and "
                         f"{depth_src.device}; want both on one CUDA device "
                         f"or both on the CPU")
    for t in (depth_ref, depth_src):
        if t.dtype != torch.float32 or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"geo_consistency: want contiguous (H, W) "
                             f"float32 depths, got {tuple(t.shape)} {t.dtype}")
    if depth_ref.shape != depth_src.shape:
        raise ValueError(f"geo_consistency: shapes {tuple(depth_ref.shape)} "
                         f"and {tuple(depth_src.shape)} differ")
    H, W = depth_ref.shape
    if H > 65535 or W >= 2 ** 31 - 128:
        raise ValueError(f"geo_consistency: {H}x{W} exceeds the kernel's "
                         f"grid (65,535 rows)")
    lib = _load()
    gm = GeoMats()
    for name, n in MAT_FIELDS:
        getattr(gm, name)[:] = [float(v) for v in mats[name]]
    dev = depth_ref.device
    mask = torch.empty((H, W), dtype=torch.bool, device=dev)
    depth_out = torch.empty((H, W), dtype=torch.float64, device=dev)
    xs = torch.empty_like(depth_out) if xy else None
    ys = torch.empty_like(depth_out) if xy else None
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The kernel writes 0/1 bytes, which is torch.bool's storage.
    rc = lib.geo_consistency_launch(
        depth_ref.data_ptr(), depth_src.data_ptr(), H, W, gm,
        float(filter_dist), float(filter_diff), mask.data_ptr(),
        depth_out.data_ptr(), xs.data_ptr() if xy else None,
        ys.data_ptr() if xy else None, stream)
    if rc != 0:
        raise RuntimeError("geo_consistency kernel launch failed: "
                           + lib.geo_consistency_error_string(rc).decode())
    geo_consistency.launches += 1
    return mask, depth_out, xs, ys


geo_consistency.launches = 0


def io_bytes(H: int, W: int) -> int:
    """The bytes a launch as fusion makes it (no source coordinates)
    must move: both float32 depth maps read once, the mask (1 byte) and
    the float64 depth written once."""
    return H * W * (4 + 4 + 1 + 8)
