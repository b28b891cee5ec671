"""cost_mapping — resample the MVS probability volumes along VolSDF rays
(counterpart of s_volsdf_tpu/ops/cost_mapping.py:66-85, 152-242, 325-352):
the CUDA kernel `csrc/cost_mapping.cu` and its plain PyTorch version.

Every ray sample is projected into every training view, its depth is
normalised into that view's hypothesis slab (bilinear near/far planes),
and the (D, Hc, Wc) probability volume is sampled trilinearly with
grid_sample's align_corners=True / zeros-padding semantics. Same-view
probability (pi) and the other-view sum (pj) feed the GCE loss.

The port reads the UNPACKED (V, D, Hc, Wc) volume with eight direct
gathers per sample; the JAX package's 8x corner-cube pack
(`pack_volumes`) is a TPU gather workaround and is not ported. Corner
weights and the out-of-range rule are the JAX ones: lookup indices are
clamped, weights come from the unclamped floor index, and a corner past
the edge contributes zero. Forward only: the inputs are detached.

The volume may be float32 or bfloat16 (the trainer stores it in
`train.mvs_pack_dtype`, as the JAX package packs it); each value is
promoted to float32 before its weight, JAX's order. The near/far planes
stay float32.

Dispatch is by the device of `xyz` alone. A CPU tensor goes through the
plain version; a CUDA tensor launches the kernel (one launch per call,
counted in `cost_mapping.launches`) or raises. There is no fallback from
the kernel to the plain version. The plain version is written in the
kernel's order of operations with no matrix product and no division by
a scalar (which the card's torch turns into a product by its
reciprocal), so that on the card the two agree to the bit, masks
included. The kernel library is built with nvcc (`--fmad=false`) at
first use into `_build/` and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from s_volsdf_tpu_torch.ops.build import (CSRC_DIR, NVCC_FLAGS,
                                          build_library, nvcc)

SOURCE = os.path.join(CSRC_DIR, "cost_mapping.cu")
# Every product and sum rounds on its own, as in the plain version.
FLAGS = NVCC_FLAGS + ["--fmad=false"]
SECTOR = 32   # bytes the card's memory moves at the least


@dataclass
class MVSVolumes:
    """Per-training-view MVS outputs, stacked over views V.

    prob: (V, D, Hc, Wc) probability volumes, float32 or bfloat16.
    z_slab: (V, 2, Hc, Wc) near/far hypothesis planes.
    intrinsics, c2w: (V, 4, 4) VolSDF-resolution cameras.
    img_res: (H, W) of the VolSDF image grid.
    inverse_depth: slab normalisation uniform in 1/z (stage 0 of
      unbounded scenes).
    """
    prob: torch.Tensor
    z_slab: torch.Tensor
    intrinsics: torch.Tensor
    c2w: torch.Tensor
    img_res: Tuple[int, int]
    inverse_depth: bool


def _unnormalize(coord, size: int):
    """[-1, 1] -> index space, align_corners=True."""
    return (coord + 1.0) * 0.5 * (size - 1)


def _corner_wgt(i, w):
    """Linear weight of corner offset i from the true floor corner: 1-w
    at 0, w at 1, 0 for any other offset (a corner clamped away)."""
    return torch.where(i == 0, 1.0 - w,
                       torch.where(i == 1, w, torch.zeros_like(w)))


def _sample_all_views(xyz, mvs: MVSVolumes,
                      reads: Optional[List[torch.Tensor]] = None):
    """(cost (V, R, S), valid (V, R, S)) of xyz (R, S, 3) in every view.
    With `reads`, appends the flat indices read from the near/far planes
    and from the volume."""
    V, Dv, Hv, Wv = mvs.prob.shape
    H, W = mvs.img_res
    K, c2w = mvs.intrinsics, mvs.c2w

    p = xyz[None] - c2w[:, None, None, :3, 3]          # (V, R, S, 3)
    R = c2w[:, None, None, :3, :3]
    # p @ R, as three products and two sums in this order.
    p = (p[..., 0:1] * R[..., 0, :] + p[..., 1:2] * R[..., 1, :]
         + p[..., 2:3] * R[..., 2, :])
    z = p[..., 2]
    fx = K[:, 0, 0][:, None, None]
    fy = K[:, 1, 1][:, None, None]
    cx = K[:, 0, 2][:, None, None]
    cy = K[:, 1, 2][:, None, None]
    sk = K[:, 0, 1][:, None, None]
    xz = p[..., 0] / z
    yz = p[..., 1] / z
    v_pix = yz * fy + cy
    u_pix = xz * fx + cx + (v_pix - cy) * sk / fy      # skew term
    u = u_pix * (2.0 / (W - 1)) - 1.0
    v = v_pix * (2.0 / (H - 1)) - 1.0

    bound_hw = 1.001
    invalid = ((z < 1e-5) | (u > bound_hw) | (u < -bound_hw)
               | (v > bound_hw) | (v < -bound_hw))
    far_away = torch.full_like(u, -99.0)
    u = torch.where(invalid, far_away, u)
    v = torch.where(invalid, far_away, v)

    shape = u.shape                                    # (V, R, S)
    uf = u.reshape(V, -1)
    vf = v.reshape(V, -1)
    zf = z.reshape(V, -1)
    x = _unnormalize(uf, Wv)
    y = _unnormalize(vf, Hv)
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    xs = torch.clamp(x0, 0, Wv - 1)
    ys = torch.clamp(y0, 0, Hv - 1)
    sx = x0 - xs
    sy = y0 - ys
    wx = x - x0
    wy = y - y0
    view = torch.arange(V, device=xyz.device)[:, None]

    # Bilinear near/far planes: corner (by, bx) is the plane at
    # (ys+by, xs+bx), zero past the edge.
    slab = mvs.z_slab.reshape(-1)
    nfv = 0.0
    for by in (0, 1):
        for bx in (0, 1):
            yb, xb = ys + by, xs + bx
            inb = (yb < Hv) & (xb < Wv)
            pix = torch.clamp(yb, max=Hv - 1) * Wv + torch.clamp(xb, max=Wv - 1)
            idx = [((view * 2 + c) * Hv) * Wv + pix for c in (0, 1)]
            if reads is not None:
                reads[0] += idx
            nf = torch.stack([slab[i] for i in idx], dim=-1)
            nf = torch.where(inb[..., None], nf, torch.zeros_like(nf))
            w = _corner_wgt(by - sy, wy) * _corner_wgt(bx - sx, wx)
            nfv = nfv + nf * w[..., None]
    near_j, far_j = nfv[..., 0], nfv[..., 1]

    if mvs.inverse_depth:
        far_safe = torch.where(far_j < 1e-5, torch.full_like(far_j, 1e-8), far_j)
        zg = 2.0 * (1.0 - near_j / zf) / (1.0 - near_j / far_safe) - 1.0
    else:
        zg = 2.0 * (zf - near_j) / (far_j - near_j) - 1.0

    bound_z = 1.01
    invalid_f = ((near_j < 1e-5) | (far_j < 1e-5)
                 | (zg > bound_z) | (zg < -bound_z)
                 | invalid.reshape(V, -1))
    zn = _unnormalize(torch.where(invalid_f, torch.full_like(zg, -99.0), zg), Dv)
    z0f = torch.floor(zn)
    z0 = z0f.to(torch.int64)
    zs = torch.clamp(z0, 0, Dv - 1)
    sz = z0 - zs
    wz = zn - z0f

    vol = mvs.prob.reshape(-1)
    cost = 0.0
    for by in (0, 1):
        for bx in (0, 1):
            yb, xb = ys + by, xs + bx
            inb_xy = (yb < Hv) & (xb < Wv)
            wxy = _corner_wgt(by - sy, wy) * _corner_wgt(bx - sx, wx)
            for bz in (0, 1):
                zb = zs + bz
                inb = inb_xy & (zb < Dv)
                idx = (((view * Dv + torch.clamp(zb, max=Dv - 1)) * Hv
                        + torch.clamp(yb, max=Hv - 1)) * Wv
                       + torch.clamp(xb, max=Wv - 1))
                if reads is not None:
                    reads[1].append(idx)
                val = torch.where(inb, vol[idx], torch.zeros_like(wz))
                cost = cost + val * (wxy * _corner_wgt(bz - sz, wz))
    return cost.reshape(shape), ~invalid_f.reshape(shape)


def cost_mapping_plain(xyz, view_onehot, mvs: MVSVolumes):
    """What the kernel computes, as eager torch ops: (pj, pi, valid) of
    xyz (R, S, 3) (see `cost_mapping`)."""
    costs, valids = _sample_all_views(xyz, mvs)    # (V, R, S)
    w_same = view_onehot[:, None, None]
    pi = torch.sum(w_same * costs, dim=0)
    pj = torch.sum((1.0 - w_same) * costs, dim=0)
    valid = torch.any((w_same == 0.0) & valids, dim=0)
    pi = torch.where(valid, pi, torch.zeros_like(pi))
    return pj, pi, valid


_LIB = None
_LIB_LOCK = threading.Lock()


def build(force: bool = False) -> str:
    """Compile csrc/cost_mapping.cu into _build/libcost_mapping.so unless
    an up-to-date library exists. Raises RuntimeError naming nvcc when
    it cannot."""
    return build_library([nvcc()] + FLAGS, SOURCE, "libcost_mapping.so",
                         force)


def bind(path: str):
    """Load a build of csrc/cost_mapping.cu and declare its C entry
    points."""
    lib = ctypes.CDLL(path)
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.cost_mapping_launch.argtypes = [
        vp, ci, vp, ci, vp, vp, vp, vp, ci, ci, ci, ci, cf, cf, ci, vp, vp,
        vp, vp]
    lib.cost_mapping_launch.restype = ci
    lib.cost_mapping_error_string.argtypes = [ci]
    lib.cost_mapping_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = bind(build())
        return _LIB


def _launch(xyz: torch.Tensor, view_onehot: torch.Tensor,
            mvs: MVSVolumes):
    """One launch of the kernel on xyz (R, S, 3) CUDA float32, or an
    exception naming what it does not take."""
    dev = xyz.device
    V, D, Hv, Wv = mvs.prob.shape
    want = {"xyz": (xyz, torch.float32, None),
            "view_onehot": (view_onehot, torch.float32, (V,)),
            "z_slab": (mvs.z_slab, torch.float32, (V, 2, Hv, Wv)),
            "intrinsics": (mvs.intrinsics, torch.float32, (V, 4, 4)),
            "c2w": (mvs.c2w, torch.float32, (V, 4, 4)),
            "prob": (mvs.prob, None, None)}
    for name, (t, dtype, shape) in want.items():
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"cost_mapping: {name} must be contiguous on "
                             f"{dev}, got {t.device}")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"cost_mapping: {name} must be {dtype}, got "
                             f"{t.dtype}")
        if shape is not None and tuple(t.shape) != shape:
            raise ValueError(f"cost_mapping: {name} of shape "
                             f"{tuple(t.shape)}, want {shape}")
    if mvs.prob.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cost_mapping: prob must be float32 or bfloat16, "
                         f"got {mvs.prob.dtype}")
    if xyz.dim() != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"cost_mapping: want xyz (R, S, 3), got "
                         f"{tuple(xyz.shape)}")
    n = xyz.shape[0] * xyz.shape[1]
    if n >= 2 ** 31 or mvs.prob.numel() >= 2 ** 62:
        raise ValueError(f"cost_mapping: {n} samples exceed int32 indexing")
    H, W = mvs.img_res
    lib = _load()
    pj = torch.empty(xyz.shape[:2], dtype=torch.float32, device=dev)
    pi = torch.empty_like(pj)
    valid = torch.empty(xyz.shape[:2], dtype=torch.bool, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    # The kernel writes 0/1 bytes, which is torch.bool's storage.
    rc = lib.cost_mapping_launch(
        xyz.data_ptr(), n, mvs.prob.data_ptr(),
        int(mvs.prob.dtype == torch.bfloat16), mvs.z_slab.data_ptr(),
        mvs.intrinsics.data_ptr(), mvs.c2w.data_ptr(), view_onehot.data_ptr(),
        V, D, Hv, Wv, 2.0 / (W - 1), 2.0 / (H - 1), int(mvs.inverse_depth),
        pj.data_ptr(), pi.data_ptr(), valid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError("cost_mapping kernel launch failed: "
                           + lib.cost_mapping_error_string(rc).decode())
    cost_mapping.launches += 1
    return pj, pi, valid


def cost_mapping(z_vals, xyz, view_onehot, mvs: MVSVolumes):
    """Project all ray samples into all views and sample probabilities.

    z_vals: (R, S) (shape only); xyz: (R, S, 3) world sample points,
    detached; view_onehot: (V,) float, 1.0 at this batch's view.
    Returns (pj, pi, valid): the other-view cost sum, the same-view cost
    masked to samples seen by >= 1 other view, and that mask.

    CPU tensors: `cost_mapping_plain`. CUDA tensors: one launch of the
    kernel on the current stream, or an exception.
    """
    del z_vals
    with torch.no_grad():
        xyz = xyz.detach()
        if xyz.device.type == "cpu":
            return cost_mapping_plain(xyz, view_onehot, mvs)
        if xyz.device.type != "cuda":
            raise ValueError(f"cost_mapping: unsupported device {xyz.device}")
        return _launch(xyz.contiguous(), view_onehot.contiguous(), mvs)


cost_mapping.launches = 0


def touched_bytes(xyz, mvs: MVSVolumes) -> int:
    """The bytes a cost_mapping of xyz (R, S, 3) must move at the least:
    every 32-byte sector of the near/far planes and of the volume that
    some sample reads, once, and each sample's xyz read and pj, pi and
    valid written once."""
    reads: List[List[torch.Tensor]] = [[], []]
    with torch.no_grad():
        _sample_all_views(xyz.detach(), mvs, reads=reads)
    total = 0
    for idx, itemsize in ((reads[0], mvs.z_slab.element_size()),
                          (reads[1], mvs.prob.element_size())):
        sectors = torch.cat([i.reshape(-1) for i in idx]) * itemsize // SECTOR
        total += int(torch.unique(sectors).numel()) * SECTOR
    n = xyz.shape[0] * xyz.shape[1]
    return total + n * (12 + 4 + 4 + 1)
