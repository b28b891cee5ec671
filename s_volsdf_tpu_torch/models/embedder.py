"""Positional (Fourier) encoding (counterpart of
s_volsdf_tpu/models/embedder.py)."""

from __future__ import annotations

import torch


def embed_dim(multires: int, input_dims: int = 3) -> int:
    """Output dimension of `positional_encoding`."""
    if multires <= 0:
        return input_dims
    return input_dims * (1 + 2 * multires)


def positional_encoding(x: torch.Tensor, multires: int) -> torch.Tensor:
    """(..., D) -> (..., D * (1 + 2*multires)), ordered
    [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]."""
    if multires <= 0:
        return x
    freqs = 2.0 ** torch.arange(multires, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]                  # (..., F, D)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)
    enc = enc.reshape(*x.shape[:-1], 2 * multires * x.shape[-1])
    return torch.cat([x, enc], dim=-1)
