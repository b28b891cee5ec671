"""Weight-normalised MLP layers (counterpart of
s_volsdf_tpu/models/layers.py:25-132).

The JAX layout and leaf names are kept: `v` is (d_in, d_out), so a layer
applies as `x @ W + b` (`apply_linear`), and `g` (d_out,) rescales each
output COLUMN of
`v`. That is why `torch.nn.utils.weight_norm` is not used: its `dim`
convention is for torch's (out, in) weights. The norm is epsilon-free,
like the JAX layer's.

`apply_linear(p, x, compute_dtype)` is the JAX `apply_linear`: with
bfloat16, both operands are rounded to bf16 and the product is
accumulated and returned in float32 (JAX's `preferred_element_type`),
then the float32 bias is added.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class WeightNormLinear(nn.Module):
    """W = g * v / ||v||_0 (norm over axis 0 of v (in, out))."""

    def __init__(self, v: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(g)
        self.b = nn.Parameter(b)

    def weight(self) -> torch.Tensor:
        return self.g * self.v / torch.linalg.norm(self.v, dim=0, keepdim=True)


class Linear(nn.Module):
    """Plain layer with JAX leaves `w` (in, out) and `b` (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def weight(self) -> torch.Tensor:
        return self.w


def apply_linear(p: nn.Module, x: torch.Tensor,
                 compute_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x @ W + b (W with its weight norm applied in float32). With
    compute_dtype=torch.bfloat16: x and W rounded to bf16, their product
    accumulated and returned in float32, plus the float32 bias.

    The product is the float32 product of the rounded operands: every
    product of two bf16 values is exact in float32, so this is the value
    of a bf16 product with float32 accumulation, in the order the
    float32 matmul sums. It runs so on the card too, because torch's
    bf16 product with a float32 result (`torch.mm(a, b,
    out_dtype=torch.float32)`) has no derivative, and the eikonal term
    differentiates through these layers twice. The callers keep TF32 off
    (`utils.device.full_float32`), so the sums are float32."""
    w = p.weight()
    if compute_dtype is None:
        return x @ w + p.b
    xq = x.to(compute_dtype).float()
    return xq @ w.to(compute_dtype).float() + p.b


def softplus_b(x: torch.Tensor, beta: float = 100.0) -> torch.Tensor:
    """softplus(beta*x)/beta in jax.nn.softplus's form,
    max(z, 0) + log1p(exp(-|z|)). torch's F.softplus switches to the
    identity above its threshold of 20 instead; the two differ by less
    than 1e-10 there, but this form is the one the JAX package and the
    CUDA kernel compute."""
    z = beta * x
    return (torch.clamp(z, min=0.0) + torch.log1p(torch.exp(-torch.abs(z)))) / beta


def _pack(w: torch.Tensor, b: torch.Tensor, weight_norm: bool) -> nn.Module:
    """With weight norm, g is set so W == g * v/||v|| at init."""
    if weight_norm:
        return WeightNormLinear(w, torch.linalg.norm(w, dim=0), b)
    return Linear(w, b)


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=gen, dtype=torch.float32)


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                weight_norm: bool = True) -> nn.Module:
    """W ~ N(0, sqrt(2)/sqrt(d_out)), b = 0."""
    std = math.sqrt(2.0) / math.sqrt(d_out)
    w = std * _normal(gen, (d_in, d_out))
    b = torch.zeros((d_out,), dtype=torch.float32)
    return _pack(w, b, weight_norm)


def init_sdf_mlp(gen: torch.Generator, d_in: int, d_out: int,
                 dims: Sequence[int], feature_size: int,
                 skip_in: Tuple[int, ...], multires: int,
                 geometric_init: bool, bias: float, weight_norm: bool,
                 device=None) -> nn.ModuleList:
    """SDF MLP with geometric (sphere) init: sdf(x) ~ ||x|| - bias.

    Widths are [d_pe] + dims + [d_out + feature_size]; the layer that
    feeds a skip junction has its output shrunk by d_pe, so that the
    concatenation [h, pe] is as wide as the next layer's input."""
    from s_volsdf_tpu_torch.models.embedder import embed_dim

    d_pe = embed_dim(multires, d_in)
    widths = [d_pe] + list(dims) + [d_out + feature_size]
    n_layers = len(widths)
    layers = []
    for layer in range(n_layers - 1):
        out_dim = widths[layer + 1]
        if layer + 1 in skip_in:
            out_dim = widths[layer + 1] - widths[0]
        in_dim = widths[layer]
        std = math.sqrt(2.0) / math.sqrt(out_dim)
        b = torch.zeros((out_dim,), dtype=torch.float32)
        if geometric_init and layer == n_layers - 2:
            mean = math.sqrt(math.pi) / math.sqrt(in_dim)
            w = mean + 1e-4 * _normal(gen, (in_dim, out_dim))
            b = torch.full((out_dim,), -bias, dtype=torch.float32)
        elif geometric_init and multires > 0 and layer == 0:
            w = torch.zeros((in_dim, out_dim), dtype=torch.float32)
            w[:3] = std * _normal(gen, (3, out_dim))
        elif geometric_init and multires > 0 and layer in skip_in:
            w = std * _normal(gen, (in_dim, out_dim))
            # Zero the PE (non-xyz) part of the concatenated input: the
            # LAST (d_pe - 3) input rows.
            w[-(widths[0] - 3):] = 0.0
        else:
            w = std * _normal(gen, (in_dim, out_dim))
        layers.append(_pack(w, b, weight_norm))
    return nn.ModuleList(layers).to(device)


def init_mlp(gen: torch.Generator, widths: Sequence[int], weight_norm: bool,
             device=None) -> nn.ModuleList:
    """Plain MLP init (the radiance network)."""
    layers = [init_linear(gen, widths[i], widths[i + 1], weight_norm)
              for i in range(len(widths) - 1)]
    return nn.ModuleList(layers).to(device)
