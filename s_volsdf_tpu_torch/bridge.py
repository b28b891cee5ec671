"""Parameters between the JAX package and the port.

The JAX VolSDF parameters are the pytree
{"sdf": [{"v", "g", "b"} | {"w", "b"}, ...], "rgb": [...],
 "density": {"beta"}}; the port's `VolSDFParams` keeps the same leaves in
the same layouts ((in, out) weights), so the conversion is one to one
and exact. Both functions take and give numpy arrays; neither imports
JAX.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from s_volsdf_tpu_torch.models.density import LaplaceDensity
from s_volsdf_tpu_torch.models.layers import Linear, WeightNormLinear
from s_volsdf_tpu_torch.models.network import VolSDFParams


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _mlp_from(layers_np: List[Dict], device) -> nn.ModuleList:
    mods = []
    for p in layers_np:
        if "v" in p:
            mods.append(WeightNormLinear(_tensor(p["v"], device),
                                         _tensor(p["g"], device),
                                         _tensor(p["b"], device)))
        else:
            mods.append(Linear(_tensor(p["w"], device),
                               _tensor(p["b"], device)))
    return nn.ModuleList(mods)


def from_jax_params(np_params: Dict, device=None) -> VolSDFParams:
    """JAX pytree of numpy arrays -> VolSDFParams."""
    density = LaplaceDensity(device=device)
    with torch.no_grad():
        density.beta.copy_(_tensor(np_params["density"]["beta"], device))
    return VolSDFParams(_mlp_from(np_params["sdf"], device),
                        _mlp_from(np_params["rgb"], device), density)


def _mlp_to(mods: nn.ModuleList) -> List[Dict]:
    return [{name: p.detach().cpu().numpy().copy()
             for name, p in m.named_parameters()} for m in mods]


def to_jax_params(params: VolSDFParams) -> Dict:
    """VolSDFParams -> the JAX pytree, as numpy arrays."""
    return {
        "sdf": _mlp_to(params.sdf),
        "rgb": _mlp_to(params.rgb),
        "density": {"beta": params.density.beta.detach().cpu().numpy().copy()},
    }
