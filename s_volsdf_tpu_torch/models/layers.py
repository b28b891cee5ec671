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

A layer's leaves may carry a leading scene axis (`v` (S, in, out), `g`
and `b` (S, out)): S scenes' independent layers, the port's counterpart
of a `jax.vmap` over stacked parameters (the lockstep multi-scene step,
engine/multiscene.py). The norm is over the `in` axis and the bias is
added per scene, so the same code serves both: with 2-D leaves it is
the arithmetic it always was; with 3-D leaves x is (S, M, in) and the
product is one batched matmul for the S scenes. `n_scenes` tells the two
apart, `by_scene` / `flat` move points between the flat (S*M, d) layout
of the render and the (S, M, d) layout of a stacked product.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn


class WeightNormLinear(nn.Module):
    """W = g * v / ||v||_0 (norm over the `in` axis of v (in, out), or of
    v (S, in, out) with a leading scene axis)."""

    def __init__(self, v: torch.Tensor, g: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.v = nn.Parameter(v)
        self.g = nn.Parameter(g)
        self.b = nn.Parameter(b)

    def weight(self) -> torch.Tensor:
        return self.g[..., None, :] * self.v / torch.linalg.norm(
            self.v, dim=-2, keepdim=True)


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
    b = p.b[..., None, :]
    mm = _scene_matmul if w.dim() == 3 else torch.matmul
    if compute_dtype is None:
        return mm(x, w) + b
    xq = x.to(compute_dtype).float()
    return mm(xq, w.to(compute_dtype).float()) + b


# Row blocks of a stacked product (see `_scene_matmul`).
ROW_SPLIT = 16


def _scene_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (S, M, in) @ w (S, in, out); on the card, for S > 1, with each
    scene's M rows in ROW_SPLIT blocks (when they divide M), a batched
    product of S * ROW_SPLIT entries. Its weight gradient, x^T g,
    reduces over the M rows; as S products cuBLAS runs it on S x (output
    tiles) blocks with the whole reduction in each (a single product
    splits the reduction across the card), so the blocks give it
    ROW_SPLIT times the parallelism, and autograd sums their gradients
    (an (S, ROW_SPLIT, in, out) sum, small). On an H100 that cuts the
    lockstep step's device time by about a third at S = 2 and a fifth
    at S = 4 (PERF.md; `tools/time_step.py --scenes 2 4 --row-split 16
    1`). At S = 1 the
    product is a single one already. On the CPU the S products as they
    are: there each equals the single product to the bit."""
    S, M, k = x.shape
    c = ROW_SPLIT if x.is_cuda and S > 1 and M % ROW_SPLIT == 0 else 1
    if c == 1:
        return x @ w
    return (x.reshape(S, c, M // c, k) @ w[:, None]).reshape(S, M, -1)


def n_scenes(mlp) -> int:
    """S for an MLP whose leaves carry a leading scene axis, else 0."""
    return mlp[0].b.shape[0] if mlp[0].b.dim() == 2 else 0


def by_scene(x: torch.Tensor, S: int) -> torch.Tensor:
    """Flat points (S*M, d), each scene's M contiguous, as (S, M, d) for a
    stacked MLP; x itself when S is 0."""
    return x.reshape(S, -1, x.shape[-1]) if S else x


def flat(h: torch.Tensor, S: int) -> torch.Tensor:
    """The inverse of `by_scene`."""
    return h.reshape(-1, h.shape[-1]) if S else h


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
