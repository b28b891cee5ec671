"""FMT, TransMVSNet's feature matching transformer, frozen inference
(counterpart of s_volsdf_tpu/models/mvs/fmt.py): a 2-D sine positional
encoding, linear attention with the elu + 1 feature map, and the
upsample-add pathway that carries the transformed coarse features down
to the finer stages.

Layer schedule: 4 x (self, cross). The reference view runs the "self"
layers only and keeps each one's output; a source view runs self and
cross, cross layer i attending to the reference's output i // 2.

One view's features are (C, H, W) maps; the attention works on (H * W,
C) tokens. The linears hold (in, out) weights as the JAX pytree does and
run in float32 at any `mvs.compute_dtype` (JAX casts only kernels of
ndim >= 4); the pathway's convs follow their weight's dtype.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from s_volsdf_tpu_torch.models.mvs import blocks as B

LAYER_NAMES = ("self", "cross") * 4
D_MODEL = 32
N_HEADS = 8
LN_EPS = 1e-5


class Dense(nn.Module):
    """x @ w + b with an (in, out) weight."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(d_in, d_out))
        self.b = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class LayerNorm(nn.Module):
    """LayerNorm over the last axis, biased variance, as the JAX
    `_layer_norm` writes it."""

    def __init__(self, d: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + LN_EPS) * self.scale + self.bias


def sine_position_encoding(feat: torch.Tensor,
                           d_model: int = D_MODEL) -> torch.Tensor:
    """PositionEncodingSine with temp_bug_fix: (H, W, C) + its encoding.
    Positions count from 1; channel 4i + j holds sin(x div_i), cos(x
    div_i), sin(y div_i), cos(y div_i) for j = 0..3."""
    H, W, C = feat.shape
    dev, dt = feat.device, feat.dtype
    y_pos = torch.arange(1, H + 1, dtype=dt, device=dev)[:, None]
    x_pos = torch.arange(1, W + 1, dtype=dt, device=dev)[None, :]
    div = torch.exp(torch.arange(0, d_model // 2, 2, dtype=dt, device=dev)
                    * (-math.log(10000.0) / (d_model // 2)))   # (C // 4,)
    xa = (x_pos[..., None] * div).expand(H, W, C // 4)
    ya = (y_pos[..., None] * div).expand(H, W, C // 4)
    pe = torch.stack([torch.sin(xa), torch.cos(xa), torch.sin(ya),
                      torch.cos(ya)], dim=-1).reshape(H, W, C)
    return feat + pe


def linear_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     eps: float = 1e-6) -> torch.Tensor:
    """elu + 1 kernelized attention. q (L, heads, d); k, v (S, heads, d)."""
    fq = F.elu(q) + 1.0
    fk = F.elu(k) + 1.0
    kv = torch.einsum("shd,shm->hmd", fk, v)
    z = 1.0 / (torch.einsum("lhd,hd->lh", fq, fk.sum(0)) + eps)
    return torch.einsum("lhd,hmd,lh->lhm", fq, kv, z)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int = D_MODEL, n_heads: int = N_HEADS):
        super().__init__()
        self.n_heads = n_heads
        self.q = Dense(d_model, d_model)
        self.k = Dense(d_model, d_model)
        self.v = Dense(d_model, d_model)
        self.out = Dense(d_model, d_model)
        self.ff1 = Dense(d_model, 2 * d_model)
        self.ff2 = Dense(2 * d_model, d_model)
        self.ln1 = LayerNorm(d_model)
        self.ln2 = LayerNorm(d_model)

    def forward(self, x: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
        """x (L, C) attends to source (S, C)."""
        L, C = x.shape
        S = source.shape[0]
        q = self.q(x).reshape(L, self.n_heads, -1)
        k = self.k(source).reshape(S, self.n_heads, -1)
        v = self.v(source).reshape(S, self.n_heads, -1)
        att = linear_attention(q, k, v).reshape(L, C)
        x = self.ln1(x + self.out(att))
        y = self.ff2(torch.relu(self.ff1(x)))
        return self.ln2(x + y)


class FMT(nn.Module):
    def __init__(self, d_model: int = D_MODEL, n_heads: int = N_HEADS):
        super().__init__()
        self.layers = nn.ModuleList([EncoderLayer(d_model, n_heads)
                                     for _ in LAYER_NAMES])


def _tokens(feat: torch.Tensor) -> torch.Tensor:
    """(C, H, W) -> position-encoded (H * W, C) tokens."""
    C, H, W = feat.shape
    return sine_position_encoding(feat.permute(1, 2, 0)).reshape(H * W, C)


def _map(tokens: torch.Tensor, H: int, W: int) -> torch.Tensor:
    return tokens.reshape(H, W, -1).permute(2, 0, 1)


def fmt_ref(fmt: FMT, ref_feat: torch.Tensor) -> List[torch.Tensor]:
    """The self layers over the reference view (C, H, W); returns the
    output of each, as (C, H, W)."""
    _, H, W = ref_feat.shape
    x = _tokens(ref_feat)
    outs = []
    for layer, name in zip(fmt.layers, LAYER_NAMES):
        if name == "self":
            x = layer(x, x)
            outs.append(_map(x, H, W))
    return outs


def fmt_src(fmt: FMT, ref_list: List[torch.Tensor],
            src_feat: torch.Tensor) -> torch.Tensor:
    """The self and cross layers over a source view (C, H, W)."""
    C, H, W = src_feat.shape
    refs = [r.permute(1, 2, 0).reshape(H * W, C) for r in ref_list]
    x = _tokens(src_feat)
    for i, (layer, name) in enumerate(zip(fmt.layers, LAYER_NAMES)):
        x = layer(x, x if name == "self" else refs[i // 2])
    return _map(x, H, W)


class FMTWithPathway(nn.Module):
    def __init__(self, base: int = 8):
        super().__init__()
        self.fmt = FMT()
        self.dim_reduction_1 = B.Conv2d(base * 4, base * 2, 1, bias=False)
        self.dim_reduction_2 = B.Conv2d(base * 2, base, 1, bias=False)
        self.smooth_1 = B.Conv2d(base * 2, base * 2, 3, padding=1,
                                 bias=False)
        self.smooth_2 = B.Conv2d(base, base, 3, padding=1, bias=False)


@torch.no_grad()
def init_fmt_with_pathway(net: FMTWithPathway,
                          gen: torch.Generator) -> FMTWithPathway:
    """The linears xavier-uniform from `gen`, biases 0, LayerNorms the
    identity (the JAX `init_fmt`); the convs are left to
    `blocks.init_conv_weights`."""
    for m in net.modules():
        if isinstance(m, Dense):
            bound = math.sqrt(6.0 / sum(m.w.shape))
            m.w.copy_(torch.rand(m.w.shape, generator=gen) * (2 * bound)
                      - bound)
    return net


def fmt_with_pathway(net: FMTWithPathway,
                     features: List[Dict[str, torch.Tensor]]
                     ) -> List[Dict[str, torch.Tensor]]:
    """Transform stage1 of every view (reference first), then smooth
    stages 2 and 3 through the upsample-add pathway. features: per-view
    {"stageN": (C, H, W)}."""
    def conv(c, x):
        return c(x[None])[0]

    def upsample_add(x, y):
        return B.interpolate_bilinear(x[None], y.shape[-2:])[0] + y

    out = []
    ref_list = None
    for i, f in enumerate(features):
        f = dict(f)
        if i == 0:
            ref_list = fmt_ref(net.fmt, f["stage1"])
            f["stage1"] = ref_list[-1]
        else:
            f["stage1"] = fmt_src(net.fmt, ref_list, f["stage1"])
        s2 = upsample_add(conv(net.dim_reduction_1, f["stage1"]), f["stage2"])
        f["stage2"] = conv(net.smooth_1, s2)
        s3 = upsample_add(conv(net.dim_reduction_2, f["stage2"]), f["stage3"])
        f["stage3"] = conv(net.smooth_2, s3)
        out.append(f)
    return out
