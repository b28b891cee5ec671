"""SDF -> density (counterpart of s_volsdf_tpu/models/density.py:12-25)."""

from __future__ import annotations

import torch
from torch import nn


class LaplaceDensity(nn.Module):
    """Holds the learnable scalar `beta` (the JAX leaf {"beta": ()})."""

    def __init__(self, beta_init: float = 0.1, device=None):
        super().__init__()
        self.beta = nn.Parameter(
            torch.tensor(beta_init, dtype=torch.float32, device=device))


def init_laplace_density(beta_init: float = 0.1, device=None) -> LaplaceDensity:
    return LaplaceDensity(beta_init, device)


def get_beta(params: LaplaceDensity, beta_min: float = 1e-4) -> torch.Tensor:
    """beta = |beta_param| + beta_min."""
    return torch.abs(params.beta) + beta_min


def laplace_density(sdf: torch.Tensor, beta) -> torch.Tensor:
    """alpha * Laplace(0, beta).cdf(-sdf) with alpha = 1/beta, in the
    expm1 form."""
    alpha = 1.0 / beta
    return alpha * (0.5 + 0.5 * torch.sign(sdf)
                    * torch.expm1(-torch.abs(sdf) / beta))
