"""cost_mapping — resample the MVS probability volumes along VolSDF rays
(counterpart of s_volsdf_tpu/ops/cost_mapping.py:66-85, 152-242, 325-352).

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
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass
class MVSVolumes:
    """Per-training-view MVS outputs, stacked over views V.

    prob: (V, D, Hc, Wc) probability volumes.
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


def _sample_all_views(xyz, mvs: MVSVolumes):
    """(cost (V, R, S), valid (V, R, S)) of xyz (R, S, 3) in every view."""
    V, Dv, Hv, Wv = mvs.prob.shape
    H, W = mvs.img_res
    K, c2w = mvs.intrinsics, mvs.c2w

    p = xyz[None] - c2w[:, None, None, :3, 3]          # (V, R, S, 3)
    p = torch.einsum("vrsk,vkj->vrsj", p, c2w[:, :3, :3])
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
    u = u_pix / ((W - 1) / 2.0) - 1.0
    v = v_pix / ((H - 1) / 2.0) - 1.0

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
            nf = torch.stack([slab[((view * 2 + c) * Hv) * Wv + pix]
                              for c in (0, 1)], dim=-1)
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
                val = torch.where(inb, vol[idx], torch.zeros_like(wz))
                cost = cost + val * (wxy * _corner_wgt(bz - sz, wz))
    return cost.reshape(shape), ~invalid_f.reshape(shape)


def cost_mapping(z_vals, xyz, view_onehot, mvs: MVSVolumes):
    """Project all ray samples into all views and sample probabilities.

    z_vals: (R, S) (shape only); xyz: (R, S, 3) world sample points,
    detached; view_onehot: (V,) float, 1.0 at this batch's view.
    Returns (pj, pi, valid): the other-view cost sum, the same-view cost
    masked to samples seen by >= 1 other view, and that mask.
    """
    del z_vals
    with torch.no_grad():
        costs, valids = _sample_all_views(xyz.detach(), mvs)    # (V, R, S)
        w_same = view_onehot[:, None, None]
        pi = torch.sum(w_same * costs, dim=0)
        pj = torch.sum((1.0 - w_same) * costs, dim=0)
        valid = torch.any((w_same == 0.0) & valids, dim=0)
        pi = torch.where(valid, pi, torch.zeros_like(pi))
    return pj, pi, valid
