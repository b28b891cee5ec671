"""SDF -> density (counterpart of s_volsdf_tpu/models/density.py:12-35)."""

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


def laplace_density(sdf: torch.Tensor, beta,
                    exact_tail: bool = False) -> torch.Tensor:
    """alpha * Laplace(0, beta).cdf(-sdf) with alpha = 1/beta, in the
    expm1 form.

    exact_tail: take expm1 as exp - 1 below -16. torch's float32 expm1
    (on the CPU and the card) returns -1 from about -16.6 down, a unit
    away from the correctly rounded value that JAX returns, and there
    that unit is the whole density (0.5 + 0.5 expm1). Only an interval
    of 1e10 turns it into anything: the background model's feedback
    render (`engine.render.render_depth`), whose last sample lies at the
    sphere's exit with the unclamped SDF positive, takes it. Elsewhere
    the port keeps torch's expm1, to the bit as before."""
    alpha = 1.0 / beta
    x = -torch.abs(sdf) / beta
    em1 = torch.expm1(x)
    if exact_tail:
        em1 = torch.where(x < -16.0, torch.exp(x) - 1.0, em1)
    return alpha * (0.5 + 0.5 * torch.sign(sdf) * em1)


def abs_density(x: torch.Tensor) -> torch.Tensor:
    """The NeRF++ background's density: |x|."""
    return torch.abs(x)
