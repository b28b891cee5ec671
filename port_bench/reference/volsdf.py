"""The plain reference of S-VolSDF's training step and eval render.

Plain PyTorch, one scene at a time, no kernel, no cache, no batching of
scenes: the VolSDF render (positional encoding, the weight-normalised
8x256 SDF MLP with its skip, the 4x256 radiance MLP, Laplace density,
the error-bounded sampler of VolSDF's Algorithm 1 with a static
iteration schedule), the NeRF++ background of BlendedMVS scenes, the
cost mapping of the MVS probability volumes, the S-VolSDF loss (RGB L1
with its anneal, eikonal, GCE against the volumes, sparsity), the
global-norm clip and Adam. It follows the published description as the
JAX package computes it; it is a frozen copy of the PyTorch port's plain
paths and imports nothing of the port, so a later change to the port
cannot move it.

Parameters are a dict of tensors under the port's state-dict names
("sdf.<l>.v", "sdf.<l>.g", "sdf.<l>.b", "rgb.<l>...", "density.beta",
"bg_sdf.<l>.w", ...). Configurations are the benchmark's JSON groups
("model", "train", "loss"), read as nested dicts.

Precision is a `Prec`: the rounding of every product's two operands
(None: float32; `bf16`; `fp8`) and the dtype of the hidden activations
(None or torch.bfloat16). The stated precision of a configuration gives
one (`Prec.of`); the control of the correctness check gives the next
lower one. Float32 products are computed with TF32 off unless the
caller turns it on (`tf32`).
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

INV_SQRT2 = 0.7071067811865475


def bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest bfloat16, as float32."""
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 (saturating at its largest finite value
    448), as float32."""
    return x.clamp(-448.0, 448.0).to(torch.float8_e4m3fn).float()


@dataclass(frozen=True)
class Prec:
    quant: Optional[Callable] = None          # operands of each product
    act: Optional[torch.dtype] = None         # hidden activations

    @staticmethod
    def of(compute: str, activation: str) -> "Prec":
        """The precision a configuration states: bfloat16 products (and
        bf16 activations only alongside them), else float32."""
        if compute == "bfloat16":
            return Prec(bf16, torch.bfloat16 if activation == "bfloat16"
                        else None)
        return Prec()


@contextlib.contextmanager
def tf32(allowed: bool):
    """TF32 for float32 products (cuBLAS and cuDNN) while the block
    runs."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = m.allow_tf32, c.allow_tf32
    m.allow_tf32 = c.allow_tf32 = allowed
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


# ----------------------------------------------------------------- layers

def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(...)]."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, enc], dim=-1)


def weight(P: Dict[str, torch.Tensor], name: str) -> torch.Tensor:
    """W (in, out) of layer `name`: g * v / ||v|| over the in axis with
    weight norm, else w."""
    if f"{name}.v" in P:
        v = P[f"{name}.v"]
        return P[f"{name}.g"][None, :] * v / torch.linalg.norm(
            v, dim=0, keepdim=True)
    return P[f"{name}.w"]


def linear(P, name: str, x: torch.Tensor, quant=None,
           cols: Optional[int] = None) -> torch.Tensor:
    """x @ W + b with each operand rounded by `quant`, the product summed
    and returned in float32; `cols` keeps the first output columns."""
    w, b = weight(P, name), P[f"{name}.b"]
    if cols is not None:
        w, b = w[:, :cols], b[:cols]
    if quant is not None:
        x, w = quant(x.float()), quant(w)
    return x.float() @ w + b


def _softplus(z):
    return torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))


class _Softplus(torch.autograd.Function):
    """jax.nn.softplus with its derivative exp(z - softplus(z)), used for
    bf16 activations, where it differs from autograd's of the three
    ops."""

    @staticmethod
    def forward(ctx, z):
        sp = _softplus(z)
        ctx.save_for_backward(z, sp)
        return sp

    @staticmethod
    def backward(ctx, g):
        z, sp = ctx.saved_tensors
        return g * torch.exp(z - sp)


def softplus_b(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    z = beta * x
    return (_softplus(z) if z.dtype == torch.float32
            else _Softplus.apply(z)) / beta


def sdf_mlp(P, prefix: str, n_layers: int, imp: Dict, x: torch.Tensor,
            prec: Prec, sdf_only: bool = False) -> torch.Tensor:
    """The SDF MLP on x (N, d): (N, 1 + features), or (N, 1) with
    `sdf_only` (the last layer's SDF column alone, as a sweep needs)."""
    inp = positional_encoding(x, imp["multires"])
    h = inp
    for l in range(n_layers):
        if l in imp["skip_in"]:
            if prec.act is not None:
                h = torch.cat([h, inp.to(h.dtype)], dim=-1) * torch.tensor(
                    INV_SQRT2, dtype=h.dtype)
            else:
                h = torch.cat([h, inp], dim=-1) * INV_SQRT2
        last = l == n_layers - 1
        h = linear(P, f"{prefix}.{l}", h, prec.quant,
                   cols=1 if (last and sdf_only) else None)
        if not last:
            if prec.act is not None:
                h = h.to(prec.act)
            h = softplus_b(h)
    return h


def n_layers(P, prefix: str) -> int:
    n = 0
    while f"{prefix}.{n}.b" in P:
        n += 1
    return n


def clamp_sdf(sdf, x, sphere_scale: float, bounding_sphere: float):
    if bounding_sphere > 0.0:
        sdf = torch.minimum(sdf, sphere_scale * (
            bounding_sphere - torch.linalg.norm(x, dim=-1, keepdim=True)))
    return sdf


def rgb_mlp(P, prefix: str, ren: Dict, points, normals, view_dirs, feats,
            prec: Prec) -> torch.Tensor:
    view_pe = positional_encoding(view_dirs, ren["multires_view"])
    if ren["mode"] == "idr":
        h = torch.cat([points, view_pe, normals, feats], dim=-1)
    else:
        h = torch.cat([view_pe, feats], dim=-1)
    n = n_layers(P, prefix)
    for l in range(n):
        h = linear(P, f"{prefix}.{l}", h, prec.quant)
        if l < n - 1:
            if prec.act is not None:
                h = h.to(prec.act)
            h = torch.relu(h)
    return torch.sigmoid(h)


def get_beta(P, beta_min: float) -> torch.Tensor:
    return torch.abs(P["density.beta"]) + beta_min


def laplace_density(sdf, beta):
    x = -torch.abs(sdf) / beta
    return (1.0 / beta) * (0.5 + 0.5 * torch.sign(sdf) * torch.expm1(x))


def volume_rendering(z_vals, density):
    dists = z_vals[:, 1:] - z_vals[:, :-1]
    dists = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    free = dists * density
    shifted = torch.cat([torch.zeros_like(free[:, :1]), free[:, :-1]], dim=-1)
    return (1.0 - torch.exp(-free)) * torch.exp(-torch.cumsum(shifted, dim=-1))


# ----------------------------------------------------------------- cameras

def lift(x, y, z, K):
    fx, fy = K[..., 0, 0:1], K[..., 1, 1:2]
    cx, cy, sk = K[..., 0, 2:3], K[..., 1, 2:3], K[..., 0, 1:2]
    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def camera_rays(uv, pose, K):
    """uv (B, N, 2), pose and K (B, 4, 4): unit world directions
    (B, N, 3), camera centres (B, 3) and the z of each unit direction in
    the camera (B, N, 1)."""
    cam_loc = pose[..., :3, 3]
    z = torch.ones_like(uv[..., 0])
    pts = lift(uv[..., 0], uv[..., 1], z, K)
    world = torch.einsum("bij,bnj->bni", pose[..., :3, :3], pts[..., :3])
    world = world + cam_loc[..., None, :]
    dirs = world - cam_loc[..., None, :]
    dirs = dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)
    cam = pts[..., :3]
    depth_scale = (cam / torch.linalg.norm(cam, dim=-1, keepdim=True))[..., 2:3]
    return dirs, cam_loc, depth_scale


def sphere_intersections(cam_loc, ray_dirs, r=1.0):
    dot = torch.sum(ray_dirs * cam_loc, dim=-1, keepdim=True)
    under = torch.clamp(dot ** 2 - (torch.sum(cam_loc ** 2, dim=-1,
                                              keepdim=True) - r ** 2), min=0.0)
    sign = torch.tensor([-1.0, 1.0], dtype=dot.dtype, device=dot.device)
    return torch.clamp(torch.sqrt(under) * sign - dot, min=0.0)


# ----------------------------------------------------------------- sampler

def sample_pdf(bins, cdf, u):
    K = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=K - 1)
    cb, ca = torch.gather(cdf, -1, below), torch.gather(cdf, -1, above)
    bb, ba = torch.gather(bins, -1, below), torch.gather(bins, -1, above)
    denom = ca - cb
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return bb + (u - cb) / denom * (ba - bb)


def pdf_to_cdf(pdf):
    pdf = pdf / torch.sum(pdf, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    return torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)


def merge_sorted(za, sa, zb, sb):
    z, s = torch.cat([za, zb], dim=-1), torch.cat([sa, sb], dim=-1)
    keys = torch.where(torch.isnan(z), torch.full_like(z, math.inf), z)
    order = torch.sort(keys, dim=-1, stable=True).indices
    return torch.gather(z, -1, order), torch.gather(s, -1, order)


def uniform_z(s: Dict, ray_dirs, cam_loc, far: float, n: int, training: bool,
              sphere: bool, r: float, t_rand=None, near: Optional[float] = None):
    R = ray_dirs.shape[0]
    near_v = torch.full((R, 1), s["near"] if near is None else near,
                        dtype=ray_dirs.dtype, device=ray_dirs.device)
    if sphere:
        far_v = torch.maximum(sphere_intersections(cam_loc, ray_dirs, r)[:, 1:],
                              near_v)
    else:
        far_v = torch.full((R, 1), far, dtype=ray_dirs.dtype,
                           device=ray_dirs.device)
    t = torch.linspace(0.0, 1.0, n, dtype=ray_dirs.dtype, device=ray_dirs.device)
    z = near_v * (1.0 - t) + far_v * t
    if training:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], dim=-1)
        lower = torch.cat([z[..., :1], mids], dim=-1)
        z = lower + (upper - lower) * t_rand
    return z


def _d_star(z, d):
    a = z[:, 1:] - z[:, :-1]
    b, c = torch.abs(d[:, :-1]), torch.abs(d[:, 1:])
    first = a ** 2 + b ** 2 <= c ** 2
    second = a ** 2 + c ** 2 <= b ** 2
    p = (a + b + c) / 2.0
    area = p * (p - a) * (p - b) * (p - c)
    height = 2.0 * torch.sqrt(torch.clamp(area, min=0.0)) / torch.clamp(a, min=1e-12)
    inner = (~first) & (~second) & (b + c - a > 0)
    zero = torch.zeros_like(b)
    ds = torch.where(first, b, zero)
    ds = torch.where(second, c, ds)
    ds = torch.where(inner, height, ds)
    same = torch.sign(d[:, 1:]) * torch.sign(d[:, :-1]) == 1
    return torch.where(same, ds, zero)


def _error_bound(beta, sdf, dists, d_star):
    density = laplace_density(sdf, beta)
    shifted = torch.cat([torch.zeros_like(dists[:, :1]),
                         dists * density[:, :-1]], dim=-1)
    integral = torch.cumsum(shifted, dim=-1)
    per = torch.exp(-d_star / beta) * dists ** 2 / (4 * beta ** 2)
    bound = (torch.clamp(torch.exp(torch.cumsum(per, dim=-1)), max=1e6) - 1.0) \
        * torch.exp(-integral[:, :-1])
    return torch.max(bound, dim=-1).values


def _weights(z, sdf, beta):
    density = laplace_density(sdf, beta)
    dists = z[:, 1:] - z[:, :-1]
    d_inf = torch.cat([dists, torch.full_like(dists[:, :1], 1e10)], dim=-1)
    free = d_inf * density
    shifted = torch.cat([torch.zeros_like(free[:, :1]), free[:, :-1]], dim=-1)
    trans = torch.exp(-torch.cumsum(shifted, dim=-1))
    return (1.0 - torch.exp(-free)) * trans, dists, trans


def error_bound_sample(s: Dict, ray_dirs, cam_loc, sdf_fn, beta0, *,
                       n_iters: int, training: bool, r: float, draws=None):
    """VolSDF's error-bounded sampler with the static schedule: n_iters
    iterations, the last the final one; once every ray's bisected beta
    reaches beta0, the remaining iterations append zero-length
    duplicates of the far sample. `draws` (training): t_rand, u_final,
    extra_idx, eik_idx and, with a background, t_rand_bg. Returns
    (z_final, z_eik or None, z_bg or None)."""
    far = 2.0 * r
    R = ray_dirs.shape[0]
    dev = ray_dirs.device
    Ne = s["N_samples_eval"]

    def eval_sdf(z):
        pts = cam_loc[:, None, :] + z[..., None] * ray_dirs[:, None, :]
        return sdf_fn(pts.reshape(-1, 3)).reshape(z.shape)

    z = uniform_z(s, ray_dirs, cam_loc, far, Ne, training,
                  s["inverse_sphere_bg"], r,
                  t_rand=None if draws is None else draws["t_rand"])
    sdf = eval_sdf(z)
    d0 = z[:, 1:] - z[:, :-1]
    beta = torch.sqrt((1.0 / (4.0 * math.log(s["eps"] + 1.0)))
                      * torch.sum(d0 ** 2, dim=-1))

    def bisect(z, sdf, beta, d_star, dists):
        err = _error_bound(beta0, sdf, dists, d_star)
        beta = torch.where(err <= s["eps"], beta0, beta)
        lo, hi = beta0.expand_as(beta), beta
        for _ in range(s["beta_iters"]):
            mid = 0.5 * (lo + hi)
            ok = _error_bound(mid[:, None], sdf, dists, d_star) <= s["eps"]
            hi = torch.where(ok, mid, hi)
            lo = torch.where(ok, lo, mid)
        return hi

    def dup(z, sdf):
        return (torch.cat([z, z[:, -1:].expand(R, Ne)], dim=-1),
                torch.cat([sdf, sdf[:, -1:].expand(R, Ne)], dim=-1))

    converged = False
    for _ in range(n_iters - 1):
        if converged:
            z, sdf = dup(z, sdf)
            continue
        d_star = _d_star(z, sdf)
        dists = z[:, 1:] - z[:, :-1]
        beta = bisect(z, sdf, beta, d_star, dists)
        _, _, trans = _weights(z, sdf, beta[:, None])
        if bool((torch.max(beta) <= beta0).item()):
            converged = True
            z, sdf = dup(z, sdf)
            continue
        per = torch.exp(-d_star / beta[:, None]) * dists ** 2 / (4 * beta[:, None] ** 2)
        bound = (torch.clamp(torch.exp(torch.cumsum(per, dim=-1)), max=1e6)
                 - 1.0) * trans[:, :-1]
        cdf = pdf_to_cdf(bound + s["add_tiny"])
        u = torch.linspace(0.0, 1.0, Ne, dtype=z.dtype, device=dev).expand(R, Ne)
        new = sample_pdf(z, cdf, u.contiguous())
        z, sdf = merge_sorted(z, sdf, new, eval_sdf(new))
    if converged:
        w, _, _ = _weights(z, sdf, beta0.expand(R)[:, None])
    else:
        d_star = _d_star(z, sdf)
        dists = z[:, 1:] - z[:, :-1]
        w, _, _ = _weights(z, sdf, bisect(z, sdf, beta, d_star, dists)[:, None])
    cdf = pdf_to_cdf(w[..., :-1] + 1e-5)
    ns = s["N_samples"]
    u = (draws["u_final"] if training else torch.linspace(
        0.0, 1.0, ns, dtype=z.dtype, device=dev).expand(R, ns))
    samples = sample_pdf(z, cdf, u.contiguous())
    near_col = torch.full((R, 1), s["near"], dtype=z.dtype, device=dev)
    far_col = (sphere_intersections(cam_loc, ray_dirs, r)[:, 1:]
               if s["inverse_sphere_bg"]
               else torch.full((R, 1), far, dtype=z.dtype, device=dev))
    K = z.shape[1]
    extra = [near_col, far_col]
    if s["N_samples_extra"] > 0:
        n = s["N_samples_extra"]
        step = (K - 1) / (n - 1) if n > 1 else 0.0
        cols = [int(i * step) for i in range(n - 1)] + [K - 1]
        idx = (draws["extra_idx"] if training
               else torch.as_tensor(cols[:n], device=dev))
        extra.append(z[:, idx.long()])
    z_final = torch.sort(torch.cat([samples] + extra, dim=-1), dim=-1).values
    z_eik = (torch.gather(z_final, -1, draws["eik_idx"].long())
             if training else None)
    z_bg = None
    if s["inverse_sphere_bg"]:
        z_bg = uniform_z(s, ray_dirs, cam_loc, 1.0,
                         s["N_samples_inverse_sphere"], training, False, 1.0,
                         t_rand=None if draws is None else draws["t_rand_bg"],
                         near=0.0) * (1.0 / r)
    return z_final, z_eik, z_bg


# ----------------------------------------------------------------- render

def sdf_with_grad(P, m: Dict, x, bounding: float, prec: Prec, create_graph):
    """(clamped sdf (N, 1), features, d sdf / dx) of the final samples."""
    imp = m["implicit"]
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        out = sdf_mlp(P, "sdf", n_layers(P, "sdf"), imp, x, prec)
        sdf = clamp_sdf(out[..., :1], x, imp["sphere_scale"], bounding)
        (g,) = torch.autograd.grad(sdf.sum(), x, create_graph=create_graph)
    return sdf, out[..., 1:], g


def sweep_fn(P, m: Dict, bounding: float, prec: Prec):
    """The sampler's no-grad SDF sweep."""
    imp = m["implicit"]
    nl = n_layers(P, "sdf")

    def fn(x):
        with torch.no_grad():
            sdf = sdf_mlp(P, "sdf", nl, imp, x, prec, sdf_only=True)
            return clamp_sdf(sdf, x, imp["sphere_scale"], bounding)[..., 0]
    return fn


def bg_points(ray_o, ray_d, depth, r: float):
    """NeRF++'s inverted-sphere points (x', y', z', 1/r) and real depths."""
    o_dot_d = torch.sum(ray_d * ray_o, dim=-1)
    under = o_dot_d ** 2 - (torch.sum(ray_o ** 2, dim=-1) - r ** 2)
    d_sphere = torch.sqrt(torch.clamp(under, min=0.0)) - o_dot_d
    p_sphere = ray_o + d_sphere[..., None] * ray_d
    p_mid = ray_o - o_dot_d[..., None] * ray_d
    p_mid_norm = torch.linalg.norm(p_mid, dim=-1)
    axis = torch.linalg.cross(ray_o, p_sphere, dim=-1)
    axis = axis / torch.linalg.norm(axis, dim=-1, keepdim=True)
    phi = torch.asin(torch.clamp(p_mid_norm / r, -1.0, 1.0))
    theta = torch.asin(torch.clamp(p_mid_norm * depth, -1.0, 1.0))
    ang = (phi - theta)[..., None]
    p_new = (p_sphere * torch.cos(ang)
             + torch.linalg.cross(axis, p_sphere, dim=-1) * torch.sin(ang)
             + axis * torch.sum(axis * p_sphere, dim=-1, keepdim=True)
             * (1.0 - torch.cos(ang)))
    p_new = p_new / torch.linalg.norm(p_new, dim=-1, keepdim=True)
    d1 = -o_dot_d / torch.sum(ray_d * ray_d, dim=-1)
    real = 1.0 / (depth + 1e-6) * torch.cos(theta) * (
        1.0 / torch.linalg.norm(ray_d, dim=-1)) + d1
    return torch.cat([p_new, depth[..., None]], dim=-1), real


def render(P, m: Dict, uv, pose, K, prec: Prec, *, training: bool,
           n_iters: int, draws=None) -> Dict[str, torch.Tensor]:
    """The VolSDF render of uv (1, N, 2) under pose and K (1, 4, 4):
    rgb, depth, weights, sample points and their z-depths, and in
    training the eikonal gradients (with a background model also the
    depth over foreground and background), at eval the normal map and
    acc."""
    s = m["sampler"]
    r = m["scene_bounding_sphere"]
    bg = m["with_background"]
    bounding = 0.0 if (m["white_bkgd"] or bg) else r
    dirs, cam, dscale = camera_rays(uv, pose, K)
    B, N, _ = dirs.shape
    R = B * N
    dirs = dirs.reshape(R, 3)
    cam = cam[:, None, :].expand(B, N, 3).reshape(R, 3)
    dscale = dscale.reshape(R, 1)
    beta = get_beta(P, m["density"]["beta_min"])
    z, z_eik, z_bg = error_bound_sample(
        s, dirs, cam, sweep_fn(P, m, bounding, prec), beta.detach(),
        n_iters=n_iters, training=training, r=r, draws=draws)
    if bg:
        z_max, z = z[:, -1], z[:, :-1]
    S = z.shape[1]
    pts = cam[:, None, :] + z[..., None] * dirs[:, None, :]
    flat = pts.reshape(-1, 3)
    sdf, feats, grads = sdf_with_grad(P, m, flat, bounding, prec, training)
    dirs_flat = dirs[:, None, :].expand(R, S, 3).reshape(-1, 3)
    rgb = rgb_mlp(P, "rgb", m["rendering"], flat, grads, dirs_flat, feats,
                  prec).reshape(R, S, 3)
    density = laplace_density(sdf[..., 0], beta).reshape(R, S)
    out = {"depth_vals": z * dscale, "xyz": pts}
    if bg:
        dists = z[:, 1:] - z[:, :-1]
        dists = torch.cat([dists, z_max[:, None] - z[:, -1:]], dim=-1)
        free = dists * density
        shifted = torch.cat([torch.zeros_like(free[:, :1]), free], dim=-1)
        trans = torch.exp(-torch.cumsum(shifted, dim=-1))
        weights, bg_trans = (1.0 - torch.exp(-free)) * trans[:, :-1], trans[:, -1]
        zb = torch.flip(z_bg, dims=(-1,))
        NB = zb.shape[1]
        bdirs = dirs[:, None, :].expand(R, NB, 3)
        bpts, bdepth = bg_points(cam[:, None, :].expand(R, NB, 3), bdirs, zb, r)
        bg_m = m["bg"]
        bout = sdf_mlp(P, "bg_sdf", n_layers(P, "bg_sdf"), bg_m["implicit"],
                       bpts.reshape(-1, 4), Prec())
        brgb = rgb_mlp(P, "bg_rgb", bg_m["rendering"], None, None,
                       bdirs.reshape(-1, 3), bout[:, 1:], Prec()).reshape(R, NB, 3)
        bdens = torch.abs(bout[:, 0]).reshape(R, NB)
        bd = zb[:, :-1] - zb[:, 1:]
        bd = torch.cat([bd, torch.full_like(bd[:, :1], 1e10)], dim=-1)
        bfree = bd * bdens
        bsh = torch.cat([torch.zeros_like(bfree[:, :1]), bfree[:, :-1]], dim=-1)
        bw = (1.0 - torch.exp(-bfree)) * torch.exp(-torch.cumsum(bsh, dim=-1))
        w_all = torch.cat([weights, bg_trans[:, None] * bw], dim=1)
        d_all = dscale * torch.cat([z, bdepth], dim=1)
        out["depth_all"] = torch.sum(w_all * d_all, dim=1, keepdim=True) / (
            torch.sum(w_all, dim=1, keepdim=True) + 1e-8)
        out["rgb"] = (torch.sum(weights[..., None] * rgb, dim=1)
                      + bg_trans[:, None] * torch.sum(bw[..., None] * brgb, dim=1))
        out["depth"] = torch.sum(weights * out["depth_vals"], dim=1,
                                 keepdim=True) / (
            torch.sum(weights, dim=1, keepdim=True) + 1e-8)
        out["acc"] = torch.sum(w_all, dim=-1)
    else:
        weights = volume_rendering(z, density)
        out["rgb"] = torch.sum(weights[..., None] * rgb, dim=1)
        out["depth"] = dscale * (torch.sum(weights * z, dim=1, keepdim=True) / (
            torch.sum(weights, dim=1, keepdim=True) + 1e-8))
        out["acc"] = torch.sum(weights, dim=-1)
        if m["white_bkgd"]:
            col = torch.tensor(m["bg_color"], dtype=out["rgb"].dtype,
                               device=out["rgb"].device)
            out["rgb"] = out["rgb"] + (1.0 - out["acc"][..., None]) * col
    out["weights"] = weights
    if training:
        eik_uniform = -r + 2.0 * r * draws["eik_pts"]
        eik_near = cam + z_eik * dirs
        eik = torch.cat([eik_uniform, eik_near], dim=0)
        with torch.enable_grad():
            x = eik.detach().requires_grad_(True)
            y = sdf_mlp(P, "sdf", n_layers(P, "sdf"), m["implicit"], x, prec)
            (out["grad_theta"],) = torch.autograd.grad(y[:, 0].sum(), x,
                                                       create_graph=True)
    else:
        g = grads.detach()
        normals = (g / torch.linalg.norm(g, dim=-1, keepdim=True)).reshape(R, S, 3)
        out["normal"] = torch.sum(weights[..., None] * normals, dim=1)
    return out


def render_pixels(P, m: Dict, pose, K, uv, prec: Prec, n_iters: int):
    """The eval render of the pixels uv (N, 2) as one chunk: rgb (N, 3),
    depth (N,), normal (N, 3), acc (N,)."""
    with torch.no_grad():
        o = render(P, m, uv[None], pose[None], K[None], prec, training=False,
                   n_iters=n_iters)
    return {"rgb": o["rgb"], "depth": o["depth"][:, 0], "normal": o["normal"],
            "acc": o["acc"]}


# ----------------------------------------------------------------- cost mapping

def _unnorm(c, size):
    return (c + 1.0) * 0.5 * (size - 1)


def _cw(i, w):
    return torch.where(i == 0, 1.0 - w, torch.where(i == 1, w, torch.zeros_like(w)))


def cost_mapping(xyz, onehot, vol: Dict):
    """(pj, pi) of the samples xyz (R, S, 3): each sample's trilinear
    probability in each view's volume (align_corners, zeros past the
    edges), pi its own view's where another view sees it, pj the other
    views' sum. vol: prob (V, D, Hc, Wc) in the dtype it is read in,
    z_slab (V, 2, Hc, Wc), K and c2w (V, 4, 4), img_res."""
    prob, slab_t = vol["prob"], vol["z_slab"]
    V, Dv, Hv, Wv = prob.shape
    H, W = vol["img_res"]
    Kv, c2w = vol["K"], vol["c2w"]
    p = xyz[None] - c2w[:, None, None, :3, 3]
    Rm = c2w[:, None, None, :3, :3]
    p = p[..., 0:1] * Rm[..., 0, :] + p[..., 1:2] * Rm[..., 1, :] + p[..., 2:3] * Rm[..., 2, :]
    z = p[..., 2]
    fx, fy = Kv[:, 0, 0][:, None, None], Kv[:, 1, 1][:, None, None]
    cx, cy = Kv[:, 0, 2][:, None, None], Kv[:, 1, 2][:, None, None]
    sk = Kv[:, 0, 1][:, None, None]
    v_pix = p[..., 1] / z * fy + cy
    u_pix = p[..., 0] / z * fx + cx + (v_pix - cy) * sk / fy
    u = u_pix * (2.0 / (W - 1)) - 1.0
    v = v_pix * (2.0 / (H - 1)) - 1.0
    bad = (z < 1e-5) | (u > 1.001) | (u < -1.001) | (v > 1.001) | (v < -1.001)
    u = torch.where(bad, torch.full_like(u, -99.0), u)
    v = torch.where(bad, torch.full_like(v, -99.0), v)
    shape = u.shape
    x = _unnorm(u.reshape(V, -1), Wv)
    y = _unnorm(v.reshape(V, -1), Hv)
    zf = z.reshape(V, -1)
    x0, y0 = torch.floor(x).long(), torch.floor(y).long()
    xs, ys = torch.clamp(x0, 0, Wv - 1), torch.clamp(y0, 0, Hv - 1)
    sx, sy, wx, wy = x0 - xs, y0 - ys, x - x0, y - y0
    view = torch.arange(V, device=xyz.device)[:, None]
    slab = slab_t.reshape(-1)
    nfv = 0.0
    for by in (0, 1):
        for bx in (0, 1):
            yb, xb = ys + by, xs + bx
            inb = (yb < Hv) & (xb < Wv)
            pix = torch.clamp(yb, max=Hv - 1) * Wv + torch.clamp(xb, max=Wv - 1)
            nf = torch.stack([slab[((view * 2 + c) * Hv) * Wv + pix]
                              for c in (0, 1)], dim=-1)
            nf = torch.where(inb[..., None], nf, torch.zeros_like(nf))
            nfv = nfv + nf * (_cw(by - sy, wy) * _cw(bx - sx, wx))[..., None]
    near, far = nfv[..., 0], nfv[..., 1]
    zg = 2.0 * (zf - near) / (far - near) - 1.0
    badf = (near < 1e-5) | (far < 1e-5) | (zg > 1.01) | (zg < -1.01) | bad.reshape(V, -1)
    zn = _unnorm(torch.where(badf, torch.full_like(zg, -99.0), zg), Dv)
    z0f = torch.floor(zn)
    z0 = z0f.long()
    zs = torch.clamp(z0, 0, Dv - 1)
    sz, wz = z0 - zs, zn - z0f
    flat = prob.reshape(-1)
    cost = 0.0
    for by in (0, 1):
        for bx in (0, 1):
            yb, xb = ys + by, xs + bx
            inb_xy = (yb < Hv) & (xb < Wv)
            wxy = _cw(by - sy, wy) * _cw(bx - sx, wx)
            for bz in (0, 1):
                zb = zs + bz
                inb = inb_xy & (zb < Dv)
                idx = (((view * Dv + torch.clamp(zb, max=Dv - 1)) * Hv
                        + torch.clamp(yb, max=Hv - 1)) * Wv
                       + torch.clamp(xb, max=Wv - 1))
                val = torch.where(inb, flat[idx].float(), torch.zeros_like(wz))
                cost = cost + val * (wxy * _cw(bz - sz, wz))
    costs, valids = cost.reshape(shape), ~badf.reshape(shape)
    pi = pj = 0.0
    valid = torch.zeros_like(valids[0])
    for vi in range(V):
        same = onehot[vi]
        pi = pi + same * costs[vi]
        pj = pj + (1.0 - same) * costs[vi]
        valid = valid | ((same == 0.0) & valids[vi])
    return pj, torch.where(valid, pi, torch.zeros_like(pi))


# ----------------------------------------------------------------- training

def draw_step(scene: Dict, gen: torch.Generator, m: Dict, n_rays: int) -> Dict:
    """One step's draws from `gen`, in the order a training step takes
    them: the view, the pixels, the stratified jitter t_rand, the final
    quantiles u_final, the extra columns, the eikonal index, with a
    background its jitter, and the uniform eikonal points."""
    H, W = scene["img_res"]
    V = scene["rgb"].shape[0]
    dev = scene["rgb"].device
    s = m["sampler"]
    view = torch.randint(0, V, (1,), generator=gen, device=dev)
    pix = torch.randint(0, H * W, (n_rays,), generator=gen, device=dev)
    uv = torch.stack([(pix % W).float(),
                      torch.div(pix, W, rounding_mode="floor").float()], dim=-1)
    flat = view * (H * W) + pix

    def rand(n):
        return torch.rand((n_rays, n), generator=gen, dtype=torch.float32,
                          device=dev)

    d = {"view": int(view), "uv": uv,
         "rgb": scene["rgb"].reshape(-1, 3)[flat],
         "rgb_smooth": scene["rgb_smooth"].reshape(-1, 3)[flat],
         "t_rand": rand(s["N_samples_eval"]), "u_final": rand(s["N_samples"])}
    n_final = s["N_samples"] + 2
    if s["N_samples_extra"] > 0:
        d["extra_idx"] = torch.randperm(s["N_samples_eval"], generator=gen,
                                        device=dev)[: s["N_samples_extra"]]
        n_final += s["N_samples_extra"]
    d["eik_idx"] = torch.randint(0, n_final, (n_rays, 1), generator=gen,
                                 device=dev)
    if s["inverse_sphere_bg"]:
        d["t_rand_bg"] = rand(s["N_samples_inverse_sphere"])
    d["eik_pts"] = rand(3)
    return d


def _mean(x):
    return torch.mean(x)


def loss_terms(o: Dict, d: Dict, L: Dict, it: int, mvs: bool) -> Dict:
    """The S-VolSDF loss of one step's render `o` on its draws `d`."""
    rgb_gt = d["rgb"]
    rgb_loss = _mean(torch.abs(o["rgb"] - rgb_gt))
    eik = _mean((torch.linalg.norm(o["grad_theta"], dim=1) - 1.0) ** 2)
    zero = torch.zeros((), device=rgb_gt.device)
    mvs_loss = sparse = anneal = zero
    if mvs and L["mvs_weight"] > 0.0:
        pw = o["pi"] * o["pj"]
        w = o["weights"]
        g = L["gce"]
        if g == 1.0:
            per = -pw * w
        elif g == 0.0:
            per = -pw * torch.log(w + 1e-8)
        else:
            per = -pw * w.detach() ** g * torch.log(w + 1e-8)
        gate = (torch.sum(pw, dim=1) > L["confi"]).float()
        mvs_loss = _mean(gate * torch.sum(per, dim=1))
    depth = o.get("depth_all", o["depth"])
    if (mvs and L["sparse_weight"] > 0.0 and L["anneal_rgb"] > 0
            and it < L["anneal_rgb"]):
        confi = torch.sum(o["pi"] * o["pj"], dim=-1)
        sparse = _mean(1.0 / (depth.squeeze() + 1e-3) * (confi < L["confi"]))
        t = torch.tensor(it, dtype=torch.float32) / L["anneal_rgb"]
        anneal = torch.clamp(1.0 - t, min=0.0).to(rgb_gt.device)
        per_ray = torch.mean(torch.abs(o["rgb"] - d["rgb_smooth"]), dim=-1)
        rgb_loss = _mean(per_ray * (confi < 1e-8))
    total = (L["rgb_weight"] * rgb_loss + L["eikonal_weight"] * eik
             + L["mvs_weight"] * mvs_loss + L["sparse_weight"] * anneal * sparse)
    return {"loss": total, "rgb_loss": rgb_loss, "eikonal_loss": eik,
            "mvs_loss": mvs_loss, "sparse_loss": sparse}


class Adam:
    """The global-norm clip at `clip` (g / ||g|| * clip where ||g|| >=
    clip), then Adam (b1 0.9, b2 0.999, eps 1e-8 outside the root), on a
    dict of leaves, from `state` ({leaf: (m, v, steps taken)}) where
    given and from zero moments elsewhere."""

    def __init__(self, P: Dict[str, torch.Tensor], lr: float,
                 clip: Optional[float], state: Optional[Dict] = None):
        self.lr, self.clip = lr, clip
        state = state or {}
        self.m = {k: state[k][0].clone() if k in state else torch.zeros_like(v)
                  for k, v in P.items()}
        self.v = {k: state[k][1].clone() if k in state else torch.zeros_like(v)
                  for k, v in P.items()}
        self.t = {k: state[k][2] if k in state else 0 for k in P}

    def clipped(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        if self.clip is None:
            return grads
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
        keep = norm < self.clip
        return {k: torch.where(keep, g, g / norm * self.clip)
                for k, g in grads.items()}

    def step(self, P, grads) -> None:
        with torch.no_grad():
            for k, g in grads.items():
                self.t[k] += 1
                c1 = 1.0 - 0.9 ** self.t[k]
                c2 = 1.0 - 0.999 ** self.t[k]
                self.m[k].lerp_(g, 1 - 0.9)
                self.v[k].mul_(0.999).addcmul_(g, g, value=1 - 0.999)
                denom = self.v[k].sqrt() / math.sqrt(c2) + 1e-8
                P[k].addcdiv_(self.m[k], denom, value=-self.lr / c1)


def volumes_as_read(vol: Dict, train: Dict) -> Dict:
    """The volumes with their probabilities in the dtype the
    configuration stores them in (train.mvs_pack_dtype)."""
    out = dict(vol)
    if train["mvs_pack_dtype"] == "bfloat16":
        out["prob"] = vol["prob"].to(torch.bfloat16)
    return out


def train_steps(P0: Dict[str, torch.Tensor], cfg: Dict, scene: Dict,
                vol: Optional[Dict], gen: torch.Generator, n_steps: int,
                prec: Prec, start: int = 0, loss_mean=None,
                opt_state: Optional[Dict] = None) -> Dict:
    """`n_steps` training steps of one scene from the parameters P0
    (copied) and Adam's `opt_state` (Adam's), the step count `start`,
    drawing from `gen`. Returns each step's loss terms, the first step's
    clipped gradient (each leaf) and the parameters after the last step.
    `loss_mean` replaces the per-ray mean of every term (a fault plants
    itself there)."""
    global _mean
    m, L, T = cfg["model"], cfg["loss"], cfg["train"]
    P = {k: v.detach().clone().requires_grad_(True) for k, v in P0.items()}
    opt = Adam(P, T["learning_rate"], 1.0 if T["grad_clip"] else None,
               opt_state)
    vol = None if vol is None else volumes_as_read(vol, T)
    losses, first = [], None
    saved = _mean
    if loss_mean is not None:
        _mean = loss_mean
    try:
        for i in range(n_steps):
            d = draw_step(scene, gen, m, T["num_pixels"])
            pose = scene["poses"][d["view"]][None]
            K = scene["K"][d["view"]][None]
            o = render(P, m, d["uv"][None], pose, K, prec, training=True,
                       n_iters=1, draws=d)
            if vol is not None:
                onehot = torch.zeros(scene["rgb"].shape[0],
                                     device=d["uv"].device)
                onehot[d["view"]] = 1.0
                with torch.no_grad():
                    o["pj"], o["pi"] = cost_mapping(o["xyz"].detach(), onehot, vol)
            terms = loss_terms(o, d, L, start + i, vol is not None)
            grads = torch.autograd.grad(terms["loss"], list(P.values()))
            grads = opt.clipped(dict(zip(P.keys(), grads)))
            if first is None:
                first = {k: g.detach().clone() for k, g in grads.items()}
            losses.append({k: float(v.detach()) for k, v in terms.items()})
            opt.step(P, grads)
    finally:
        _mean = saved
    return {"losses": losses, "first_grad": first,
            "params": {k: v.detach() for k, v in P.items()}}


def train_model_prec(cfg: Dict) -> Prec:
    """The precision a configuration states for the training render."""
    t = cfg["train"]
    return Prec.of(t["train_compute_dtype"], t["train_activation_dtype"])


def eval_model_prec(cfg: Dict) -> Prec:
    """The precision a configuration states for the eval render."""
    m = cfg["model"]
    return Prec.of(m["compute_dtype"], m["activation_dtype"])

