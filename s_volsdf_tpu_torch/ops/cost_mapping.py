"""cost_mapping — resample the MVS probability volumes along VolSDF rays
(counterpart of s_volsdf_tpu/ops/cost_mapping.py:66-85, 152-242, 325-352):
the CUDA kernel `csrc/cost_mapping.cu` and its plain PyTorch version.

Every ray sample is projected into every training view, its depth is
normalised into that view's hypothesis slab (bilinear near/far planes),
and the (D, Hc, Wc) probability volume is sampled trilinearly with
grid_sample's align_corners=True / zeros-padding semantics. Same-view
probability (pi) and the other-view sum (pj) feed the GCE loss.

The kernel reads corner-block copies of the volume and of the near/far
planes (`corner_cubes`, `slab_cubes`: the layout of the JAX package's
`pack_volumes`), so that a sample's 8 corners in a view are one 32-byte
sector, one memory request, instead of 8. They take 8 times the bytes
of what they copy (about 1 GB for bench.py's three bf16 volumes, 2 GB
in float32). `check_volumes` validates a set of volumes and makes them,
with the launch's constant arguments, as an explicit `KernelVolumes`
kept in the volumes' `kernel` field; the trainer does so once per run
(`engine.train_step.pack_for_chunk`) and drops them when the run ends.
They are a copy: a later in-place write to the volumes is not seen.
The plain version reads the volumes as the caller holds them. Corner
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
reciprocal), and sums the views one by one from view 0, as the kernel
does, so that on the card the two agree to the bit, masks included, for
any number of views. The kernel library is built with nvcc
(`--fmad=false`) at first use into `_build/` and bound with ctypes.

A call checks only `xyz` and `view_onehot`, that the volumes carry a
kernel copy made from their own tensors (else it raises, naming
`check_volumes`), and makes two allocations for its three outputs.

The scene axis (the lockstep multi-scene step, engine/multiscene.py):
`check_volumes_scenes` takes S scenes' volumes of one shape (an
override group shares D, Hv, Wv, the views, the image size and
inverse_depth; other shapes raise) and writes their corner-block copies
into one (S, V, D, Hv, Wv, 8) tensor and one (S, V, Hv, Wv, 8) tensor,
one scene at a time (so the transient is one scene's), with the cameras
stacked (S, V, 4, 4): a `SceneVolumes`. `cost_mapping` on it takes xyz
(S, N, K, 3) and the one-hots (S, V) and returns (S, N, K) outputs from
ONE launch, `blockIdx.y` the scene; a sample's arithmetic is the single
launch's, so it equals S single launches bit for bit. Its plain version
is `cost_mapping_plain` looped over the scenes. `cost_mapping.
scene_launches` counts every launch by its number of scenes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from dataclasses import dataclass, field, replace
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
    kernel: the kernel's copy of the above (`check_volumes`), or None.
    """
    prob: torch.Tensor
    z_slab: torch.Tensor
    intrinsics: torch.Tensor
    c2w: torch.Tensor
    img_res: Tuple[int, int]
    inverse_depth: bool
    kernel: Optional["KernelVolumes"] = field(default=None, repr=False,
                                              compare=False)


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


def cost_mapping_plain(xyz, view_onehot, mvs):
    """What the kernel computes, as eager torch ops: (pj, pi, valid) of
    xyz (R, S, 3) (see `cost_mapping`); for `SceneVolumes`, of xyz
    (S, N, K, 3) and view_onehot (S, V), one scene after another."""
    if isinstance(mvs, SceneVolumes):
        outs = [cost_mapping_plain(xyz[s], view_onehot[s], m)
                for s, m in enumerate(mvs.scenes)]
        return tuple(torch.stack(o) for o in zip(*outs))
    costs, valids = _sample_all_views(xyz, mvs)    # (V, R, S)
    pi = pj = 0.0
    valid = torch.zeros_like(valids[0])
    for v in range(costs.shape[0]):   # from view 0 up, as the kernel sums
        w_same = view_onehot[v]
        pi = pi + w_same * costs[v]
        pj = pj + (1.0 - w_same) * costs[v]
        valid = valid | ((w_same == 0.0) & valids[v])
    pi = torch.where(valid, pi, torch.zeros_like(pi))
    return pj, pi, valid


# Views the kernel's shared memory holds (18 floats a view in 48 KB).
MAX_VIEWS = 48 * 1024 // (18 * 4)
INT32 = 2 ** 31


def prior_depth_anchor(uv, view_onehot, mvs: MVSVolumes):
    """Per ray, the prior's winner-take-all depth and its peak
    probability at the ray's own pixel of its own view's volume, the
    gate rescue's target (counterpart of
    s_volsdf_tpu/ops/cost_mapping.py:245-322; plain torch, no kernel: it
    runs only under loss.gate_rescue, off by default).

    uv: (R, 2) pixels of the VolSDF (H, W) grid; view_onehot: (V,).
    The D-profile and the near/far planes are read bilinearly at the
    pixel (align_corners=True, zero past the edge, the corner weights of
    `cost_mapping`); the hypothesis grid between near and far is linear,
    or uniform in 1/z for inverse-depth volumes. Returns (anchor (R,),
    peak (R,)) float32, both 0 where the pixel's planes are degenerate."""
    V, Dv, Hv, Wv = mvs.prob.shape
    H, W = mvs.img_res
    view = torch.argmax(view_onehot).reshape(1)
    prob = torch.index_select(mvs.prob, 0, view)[0].reshape(Dv, -1)
    slab = torch.index_select(mvs.z_slab, 0, view)[0].reshape(2, -1)

    x = uv[:, 0] * ((Wv - 1) / (W - 1))
    y = uv[:, 1] * ((Hv - 1) / (H - 1))
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    xs = torch.clamp(x0, 0, Wv - 1)
    ys = torch.clamp(y0, 0, Hv - 1)
    sx = x0 - xs
    sy = y0 - ys
    wx = x - x0
    wy = y - y0

    nfv = 0.0
    prof = 0.0
    for by in (0, 1):
        for bx in (0, 1):
            yb, xb = ys + by, xs + bx
            inb = (yb < Hv) & (xb < Wv)
            pix = torch.clamp(yb, max=Hv - 1) * Wv + torch.clamp(xb, max=Wv - 1)
            w = _corner_wgt(by - sy, wy) * _corner_wgt(bx - sx, wx)
            nf = torch.where(inb[:, None], slab[:, pix].T,
                             torch.zeros((1, 2), dtype=slab.dtype,
                                         device=slab.device))
            nfv = nfv + nf * w[..., None]
            vals = torch.where(inb[:, None], prob[:, pix].T.float(),
                               torch.zeros((1, Dv), device=prob.device))
            prof = prof + vals * w[:, None]
    near, far = nfv[..., 0], nfv[..., 1]

    frac = torch.arange(Dv, dtype=torch.float32,
                        device=uv.device) / max(Dv - 1, 1)
    if mvs.inverse_depth:
        near_s = torch.where(near < 1e-5, torch.full_like(near, 1e-8), near)
        far_s = torch.where(far < 1e-5, torch.full_like(far, 1e-8), far)
        inv = (1.0 / near_s)[:, None] + frac[None, :] * (
            1.0 / far_s - 1.0 / near_s)[:, None]
        zgrid = 1.0 / inv
    else:
        zgrid = near[:, None] + frac[None, :] * (far - near)[:, None]

    dstar = torch.argmax(prof, dim=1)
    anchor = torch.gather(zgrid, 1, dstar[:, None])[:, 0]
    peak = torch.max(prof, dim=1).values
    valid = (near > 1e-5) & (far > 1e-5)
    zero = torch.zeros_like(anchor)
    return torch.where(valid, anchor, zero), torch.where(valid, peak, zero)


def corner_cubes(t: torch.Tensor) -> torch.Tensor:
    """(V, ..., Hv, Wv) -> (V, ..., Hv, Wv, 2 ** k): at each index, the
    values of its corner block, the last k = t.dim() - 1 axes each at +0
    and +1 (clamped at the end), the last axis varying fastest after the
    first: a (V, D, Hv, Wv) volume gives corner (by, bx, bz) of the cube
    at (z, y, x) at (by * 2 + bx) * 2 + bz, as the kernel reads it (the
    layout of the JAX package's pack_volumes)."""
    axes = list(range(1, t.dim()))
    for a in axes:            # one more index at the end of every axis
        t = torch.cat([t, t.narrow(a, t.shape[a] - 1, 1)], dim=a)
    sizes = [t.shape[a] - 1 for a in axes]
    # Offsets with the axes in the order (y, x, z, ...): rows, columns,
    # then the leading axes (depth).
    order = axes[-2:] + axes[:-2]
    corners = []
    for bits in range(2 ** len(axes)):
        view = t
        for i, a in enumerate(order):
            off = (bits >> (len(order) - 1 - i)) & 1
            view = view.narrow(a, off, sizes[a - 1])
        corners.append(view)
    return torch.stack(corners, dim=-1)


def slab_cubes(z_slab: torch.Tensor) -> torch.Tensor:
    """(V, 2, Hv, Wv) near/far planes -> (V, Hv, Wv, 8): at each pixel,
    corner (by, bx) of its 2 x 2 block, near then far, at
    (by * 2 + bx) * 2 + (0 near, 1 far)."""
    V, _, Hv, Wv = z_slab.shape
    blocks = corner_cubes(z_slab.reshape(V * 2, Hv, Wv))   # (2V, Hv, Wv, 4)
    return blocks.reshape(V, 2, Hv, Wv, 4).permute(0, 2, 3, 4, 1).reshape(
        V, Hv, Wv, 8)


class CostArgs(ctypes.Structure):
    """Mirror of `struct CostArgs` in csrc/cost_mapping.cu: the launch's
    constant arguments, built once per set of volumes."""
    _fields_ = [("prob8", ctypes.c_void_p), ("slab8", ctypes.c_void_p),
                ("intr", ctypes.c_void_p), ("c2w", ctypes.c_void_p),
                ("prob_bf16", ctypes.c_int), ("V", ctypes.c_int),
                ("D", ctypes.c_int), ("Hv", ctypes.c_int),
                ("Wv", ctypes.c_int), ("group", ctypes.c_int),
                ("u_scale", ctypes.c_float), ("v_scale", ctypes.c_float),
                ("inverse_depth", ctypes.c_int)]


@dataclass(frozen=True, eq=False)
class KernelVolumes:
    """The kernel's copy of a set of volumes, made by `check_volumes`:
    the tensors it was made from, the corner-block packs of the volume
    and the near/far planes (held, so that their memory outlives the
    arguments that point into them), their device and view count, and
    the launch's constant arguments."""
    source: Tuple[torch.Tensor, ...]
    packed: Tuple[torch.Tensor, torch.Tensor]
    img_res: Tuple[int, int]
    inverse_depth: bool
    device: torch.device
    V: int
    args: CostArgs
    ref: object          # ctypes.byref(args), made once

    def made_from(self, mvs: MVSVolumes) -> bool:
        """Whether this copy was made from `mvs`'s tensors and settings
        (a `dataclasses.replace` of one of them keeps a stale copy)."""
        t = self.source
        return (mvs.prob is t[0] and mvs.z_slab is t[1]
                and mvs.intrinsics is t[2] and mvs.c2w is t[3]
                and tuple(mvs.img_res) == self.img_res
                and bool(mvs.inverse_depth) == self.inverse_depth)


def check_volumes(mvs: MVSVolumes) -> MVSVolumes:
    """`mvs` with the kernel's copy of it in its `kernel` field: the
    volumes validated, the corner-block copies of the volume and the
    near/far planes made (`corner_cubes`, `slab_cubes`) and the launch's
    constant arguments. Returns `mvs` itself when it already carries a
    copy made from its tensors. Raises ValueError naming what the kernel
    does not take."""
    if mvs.kernel is not None and mvs.kernel.made_from(mvs):
        return mvs
    _validate(mvs)
    with torch.no_grad():
        packed = (corner_cubes(mvs.prob), slab_cubes(mvs.z_slab))
    return replace(mvs, kernel=_kernel_copy(
        _tensors(mvs), packed, mvs.intrinsics, mvs.c2w, mvs))


@dataclass
class SceneVolumes:
    """S scenes' volumes for the lockstep step: `scenes` as each scene's
    trainer holds them (the plain version reads these), and `kernel`,
    the kernel's stacked copy (`check_volumes_scenes`)."""
    scenes: Tuple[MVSVolumes, ...]
    kernel: Optional["KernelVolumes"] = field(default=None, repr=False,
                                              compare=False)

    def copy_is_current(self) -> bool:
        """Whether `kernel` was made from these scenes' tensors."""
        k = self.kernel
        return k is not None and len(k.source) == 4 * len(self.scenes) and \
            all(a is b for a, b in zip(
                k.source, (t for m in self.scenes for t in _tensors(m)))) \
            and all(tuple(m.img_res) == k.img_res
                    and bool(m.inverse_depth) == k.inverse_depth
                    for m in self.scenes)


def _tensors(mvs: MVSVolumes) -> Tuple[torch.Tensor, ...]:
    return (mvs.prob, mvs.z_slab, mvs.intrinsics, mvs.c2w)


def _validate(mvs: MVSVolumes) -> None:
    """Raises ValueError naming what the kernel does not take."""
    if mvs.prob.dim() != 4:
        raise ValueError(f"cost_mapping: prob must be (V, D, Hc, Wc), got "
                         f"{tuple(mvs.prob.shape)}")
    V, D, Hv, Wv = mvs.prob.shape
    dev = mvs.prob.device
    want = {"z_slab": (mvs.z_slab, torch.float32, (V, 2, Hv, Wv)),
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
    if min(V, D, Hv, Wv) < 1 or V > MAX_VIEWS:
        raise ValueError(f"cost_mapping: {V} views of ({D}, {Hv}, {Wv}); the "
                         f"kernel takes 1 to {MAX_VIEWS} non-empty views")
    if D * Hv * Wv >= INT32 or 2 * Hv * Wv >= INT32:
        raise ValueError(f"cost_mapping: a ({D}, {Hv}, {Wv}) volume exceeds "
                         f"int32 indexing")
    H, W = mvs.img_res
    if H < 2 or W < 2:
        raise ValueError(f"cost_mapping: img_res {mvs.img_res}")


def check_volumes_scenes(scenes) -> SceneVolumes:
    """S scenes' volumes (each as `check_volumes` takes it, of one shape
    and dtype, one image size and one inverse_depth) as a SceneVolumes
    with the kernel's stacked copy: every scene's corner-block copies
    written into one tensor, one scene at a time, and the cameras
    stacked. Raises ValueError for volumes the kernel does not take or
    whose shapes or settings differ between scenes."""
    scenes = tuple(scenes)
    if not scenes:
        raise ValueError("cost_mapping: no scenes")
    first = scenes[0]
    for s, m in enumerate(scenes):
        _validate(m)
        if not (m.prob.shape == first.prob.shape
                and m.prob.dtype == first.prob.dtype
                and m.prob.device == first.prob.device
                and tuple(m.img_res) == tuple(first.img_res)
                and bool(m.inverse_depth) == bool(first.inverse_depth)):
            raise ValueError(
                f"cost_mapping: scene {s}'s volumes {tuple(m.prob.shape)} "
                f"{m.prob.dtype} (img_res {m.img_res}, inverse_depth "
                f"{m.inverse_depth}) differ from scene 0's "
                f"{tuple(first.prob.shape)} {first.prob.dtype} (img_res "
                f"{first.img_res}, inverse_depth {first.inverse_depth}): "
                f"one lockstep launch takes scenes of one shape")
    S = len(scenes)
    V, D, Hv, Wv = first.prob.shape
    dev = first.prob.device
    with torch.no_grad():
        prob8 = torch.empty((S, V, D, Hv, Wv, 8), dtype=first.prob.dtype,
                            device=dev)
        slab8 = torch.empty((S, V, Hv, Wv, 8), device=dev)
        for s, m in enumerate(scenes):    # one scene's transient at a time
            prob8[s] = corner_cubes(m.prob)
            slab8[s] = slab_cubes(m.z_slab)
        intr = torch.stack([m.intrinsics for m in scenes])
        c2w = torch.stack([m.c2w for m in scenes])
    source = tuple(t for m in scenes for t in _tensors(m))
    return SceneVolumes(scenes, _kernel_copy(
        source, (prob8, slab8, intr, c2w), intr, c2w, first))


def _kernel_copy(source, packed, intr, c2w, mvs: MVSVolumes
                 ) -> "KernelVolumes":
    """A KernelVolumes of the corner-block copies `packed` (the volume's,
    then the planes', then any tensor the arguments point into) with the
    cameras `intr`, `c2w`, shaped as `mvs`."""
    V, D, Hv, Wv = mvs.prob.shape
    H, W = mvs.img_res
    args = CostArgs(
        packed[0].data_ptr(), packed[1].data_ptr(), intr.data_ptr(),
        c2w.data_ptr(), int(mvs.prob.dtype == torch.bfloat16), V, D, Hv,
        Wv, min(V, 32), 2.0 / (W - 1), 2.0 / (H - 1),
        int(mvs.inverse_depth))
    return KernelVolumes(source, tuple(packed), tuple(mvs.img_res),
                         bool(mvs.inverse_depth), mvs.prob.device, V, args,
                         ctypes.byref(args))


_LIB = None
_STREAM = None
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
    vp = ctypes.c_void_p
    lib.cost_mapping_launch.argtypes = [ctypes.POINTER(CostArgs), vp, vp,
                                        ctypes.c_int, vp, vp, vp, vp]
    lib.cost_mapping_launch.restype = ctypes.c_int
    lib.cost_mapping_launch_scenes.argtypes = [
        ctypes.POINTER(CostArgs), vp, vp, ctypes.c_int, ctypes.c_int, vp, vp,
        vp, vp]
    lib.cost_mapping_launch_scenes.restype = ctypes.c_int
    lib.cost_mapping_error_string.argtypes = [ctypes.c_int]
    lib.cost_mapping_error_string.restype = ctypes.c_char_p
    lib.cost_mapping_trace.argtypes = [vp, ctypes.c_int]
    lib.cost_mapping_trace.restype = ctypes.c_int
    return lib


def _load():
    """The library, built and bound at the first call, and the function
    that reads a device's current stream as an integer."""
    global _LIB, _STREAM
    with _LIB_LOCK:
        if _LIB is None:
            _STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None) \
                or (lambda i: torch.cuda.current_stream(i).cuda_stream)
            _LIB = bind(build())
        return _LIB


def _launch(xyz: torch.Tensor, view_onehot: torch.Tensor, mvs):
    """One launch of the kernel on xyz (R, S, 3) CUDA float32 (for
    SceneVolumes of S scenes: (S, N, K, 3), one-hots (S, V)), or an
    exception naming what it does not take."""
    chk = mvs.kernel
    scenes = isinstance(mvs, SceneVolumes)
    if chk is None or not (mvs.copy_is_current() if scenes
                           else chk.made_from(mvs)):
        raise ValueError("cost_mapping: the volumes carry no kernel copy "
                         "made from their own tensors; make one with "
                         "check_volumes (the trainer's pack_for_chunk "
                         "does, once per run), or check_volumes_scenes")
    S = len(mvs.scenes) if scenes else 1
    lead = (S,) if scenes else ()
    idx = chk.device.index
    if not (xyz.get_device() == idx and xyz.dtype == torch.float32
            and xyz.dim() == 3 + len(lead) and xyz.shape[:len(lead)] == lead
            and xyz.shape[-1] == 3 and xyz.is_contiguous()):
        raise ValueError(f"cost_mapping: want xyz {lead + ('R', 'S', 3)} "
                         f"float32 contiguous on {chk.device}, got "
                         f"{tuple(xyz.shape)} {xyz.dtype} on {xyz.device}")
    if not (view_onehot.get_device() == idx
            and view_onehot.dtype == torch.float32
            and view_onehot.shape == lead + (chk.V,)
            and view_onehot.is_contiguous()):
        raise ValueError(f"cost_mapping: want view_onehot {lead + (chk.V,)} "
                         f"float32 contiguous on {chk.device}, got "
                         f"{tuple(view_onehot.shape)} {view_onehot.dtype} on "
                         f"{view_onehot.device}")
    shape = tuple(xyz.shape[:-1])
    n = shape[-2] * shape[-1]
    if -(-n // (32 // chk.args.group)) * 32 >= INT32:
        raise ValueError(f"cost_mapping: {n} samples exceed int32 indexing")
    lib = _LIB if _LIB is not None else _load()
    # pj and pi in one allocation, valid (bytes 0/1) in another: views of
    # a single byte buffer cost the host more than the second allocation.
    pjpi = torch.empty((2,) + shape, device=chk.device)
    valid = torch.empty(shape, dtype=torch.bool, device=chk.device)
    ptr = pjpi.data_ptr()
    rc = lib.cost_mapping_launch_scenes(
        chk.ref, xyz.data_ptr(), view_onehot.data_ptr(), n, S, ptr,
        ptr + 4 * n * S, valid.data_ptr(), _STREAM(idx))
    if rc != 0:
        raise RuntimeError("cost_mapping kernel launch failed: "
                           + lib.cost_mapping_error_string(rc).decode())
    cost_mapping.launches += 1
    cost_mapping.scene_launches[S] = cost_mapping.scene_launches.get(S, 0) + 1
    pj, pi = pjpi.unbind(0)
    return pj, pi, valid


def cost_mapping(z_vals, xyz, view_onehot, mvs):
    """Project all ray samples into all views and sample probabilities.

    z_vals: (R, S) (shape only); xyz: (R, S, 3) world sample points,
    detached; view_onehot: (V,) float, 1.0 at this batch's view.
    Returns (pj, pi, valid): the other-view cost sum, the same-view cost
    masked to samples seen by >= 1 other view, and that mask. With
    `SceneVolumes` of S scenes (`check_volumes_scenes`): xyz
    (S, N, K, 3), view_onehot (S, V) and outputs (S, N, K).

    CPU tensors: `cost_mapping_plain`. CUDA tensors: one launch of the
    kernel on the current stream, reading `mvs.kernel` (`check_volumes`),
    or an exception.
    """
    del z_vals
    if xyz.is_cuda:
        return _launch(xyz, view_onehot, mvs)
    if xyz.device.type != "cpu":
        raise ValueError(f"cost_mapping: unsupported device {xyz.device}")
    with torch.no_grad():
        return cost_mapping_plain(xyz.detach(), view_onehot, mvs)


def reset_launches() -> None:
    """Set the launch count and the launches by number of scenes to 0."""
    cost_mapping.launches = 0
    cost_mapping.scene_launches = {}


reset_launches()


def touched_bytes(xyz, mvs: MVSVolumes) -> int:
    """The bytes a cost_mapping of xyz (R, S, 3) on the volumes as the
    caller holds them must move at the least: every 32-byte sector of
    the near/far planes and of the volume that some sample reads, once,
    and each sample's xyz read and pj, pi and valid written once."""
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


def packed_bytes(xyz, mvs: MVSVolumes) -> int:
    """The same on the kernel's corner-block copies (`check_volumes`):
    each distinct 32-byte sector of the volume's cubes (8 values a cube)
    and of the near/far blocks (32 bytes a pixel) that some sample
    reads, and each sample's 21 bytes of input and output."""
    reads: List[List[torch.Tensor]] = [[], []]
    with torch.no_grad():
        _sample_all_views(xyz.detach(), mvs, reads=reads)
    V, D, Hv, Wv = mvs.prob.shape
    cube = reads[1][0].reshape(-1)          # corner (0, 0, 0) of each cube
    pix = cube % (Hv * Wv) + cube // (D * Hv * Wv) * (Hv * Wv)
    cube_bytes = 8 * mvs.prob.element_size()
    sectors = (torch.unique(cube * cube_bytes // SECTOR).numel()
               + torch.unique(pix).numel())
    n = xyz.shape[0] * xyz.shape[1]
    return SECTOR * sectors + n * (12 + 4 + 4 + 1)
