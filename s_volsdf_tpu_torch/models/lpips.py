"""LPIPS perceptual distance, VGG variant (counterpart of
s_volsdf_tpu/models/lpips.py): VGG16's conv features at its five taps
(after relu1_2, relu2_2, relu3_3, relu4_3, relu5_3), each unit-normalised
along channels, squared differences weighted by the non-negative 1x1
"lin" layers, averaged over space and summed over the taps.

The weights are the JAX package's tree, {"features": [[{"b", "w"} per
conv] per block], "lins": [{"w"} per tap]}, with HWIO conv kernels:
`init_lpips_params` makes random ones of that shape (for tests and the
smoke run), `lpips_leaves` lists them in JAX's flatten order (a
checkpoint's `leaf_<i>`), `load_lpips` reads a checkpoint of them
(utils/checkpoint.py), and `bridge.lpips_from_jax` makes the module.
The repository holds no LPIPS weights: without a weights file the eval
reports LPIPS as None, as the JAX package does.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from s_volsdf_tpu_torch.utils import checkpoint as ckpt
from s_volsdf_tpu_torch.utils.device import full_float32

# VGG16's conv widths per block; the taps follow each block.
VGG_PLAN = ((64, 64), (128, 128), (256, 256, 256),
            (512, 512, 512), (512, 512, 512))

# LPIPS' scaling layer (ImageNet statistics in [-1, 1] units).
_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def init_lpips_params(rng: np.random.Generator) -> Dict:
    """Random weights with the JAX tree's shapes and scales (conv kernels
    N(0, 0.05^2), zero biases, lin weights |N(0, 0.01^2)|), float32."""
    params = {"features": [], "lins": []}
    cin = 3
    for block in VGG_PLAN:
        convs = []
        for cout in block:
            w = rng.standard_normal((3, 3, cin, cout)) * 0.05
            convs.append({"b": np.zeros(cout, np.float32),
                          "w": w.astype(np.float32)})
            cin = cout
        params["features"].append(convs)
        params["lins"].append(
            {"w": (np.abs(rng.standard_normal((cin, 1))) * 0.01
                   ).astype(np.float32)})
    return params


def lpips_leaves(params: Dict) -> List[np.ndarray]:
    """The JAX tree's leaves in `jax.tree_util.tree_flatten` order (dict
    keys sorted: features then lins; b then w in each conv)."""
    leaves = []
    for convs in params["features"]:
        for conv in convs:
            leaves += [conv["b"], conv["w"]]
    return leaves + [lin["w"] for lin in params["lins"]]


def _tree_from_leaves(leaves: List[np.ndarray]) -> Dict:
    it = iter(leaves)
    features = [[{"b": next(it), "w": next(it)} for _ in block]
                for block in VGG_PLAN]
    return {"features": features, "lins": [{"w": next(it)} for _ in VGG_PLAN]}


class LPIPS(nn.Module):
    """The net-lin/vgg model: `weights[k]` the k-th conv's kernel (OIHW),
    `biases[k]` its bias, `lins[t]` tap t's (C, 1) lin weights."""

    def __init__(self, weights: List[torch.Tensor], biases: List[torch.Tensor],
                 lins: List[torch.Tensor]):
        super().__init__()
        self.weights = nn.ParameterList(weights)
        self.biases = nn.ParameterList(biases)
        self.lins = nn.ParameterList(lins)
        self.requires_grad_(False)

    def features(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x (N, H, W, 3) in [0, 1] -> the five taps (N, C, h, w)."""
        shift = x.new_tensor(_SHIFT)
        scale = x.new_tensor(_SCALE)
        x = ((2.0 * x - 1.0 - shift) / scale).permute(0, 3, 1, 2)
        taps, k = [], 0
        for b, block in enumerate(VGG_PLAN):
            for _ in block:
                x = torch.relu(F.conv2d(x, self.weights[k], self.biases[k],
                                        padding=1))
                k += 1
            taps.append(x)
            if b < len(VGG_PLAN) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        total = 0.0
        for a, b, lin in zip(self.features(img0), self.features(img1),
                             self.lins):
            na = a / (torch.linalg.norm(a, dim=1, keepdim=True) + 1e-10)
            nb = b / (torch.linalg.norm(b, dim=1, keepdim=True) + 1e-10)
            diff = (na - nb) ** 2                               # (N, C, h, w)
            val = torch.einsum("nchw,c->nhw", diff,
                               torch.clamp(lin[:, 0], min=0.0))
            total = total + val.mean(dim=(1, 2))
        return total


def lpips_distance(model: LPIPS, img0: torch.Tensor,
                   img1: torch.Tensor) -> torch.Tensor:
    """LPIPS (N,) of img0 and img1 (N, H, W, 3) in [0, 1], without
    gradient, in full float32 on the card."""
    with torch.no_grad(), full_float32():
        return model(img0, img1)


def _shapes() -> List[np.ndarray]:
    """Zero-stride arrays with the leaves' shapes (a load template)."""
    shapes, cin = [], 3
    for block in VGG_PLAN:
        for cout in block:
            shapes += [(cout,), (3, 3, cin, cout)]
            cin = cout
    shapes += [(c[-1], 1) for c in VGG_PLAN]
    return [np.broadcast_to(np.float32(0), s) for s in shapes]


def load_lpips(path: str, device=None) -> Optional[LPIPS]:
    """The module on `device` from a checkpoint directory (state.npz of
    the JAX tree's leaves, as the JAX `load_lpips` reads it); None when
    `path` does not exist."""
    if not os.path.exists(path):
        return None
    from s_volsdf_tpu_torch.bridge import lpips_from_jax
    leaves, _, _ = ckpt.load_state(path, _shapes())
    return lpips_from_jax(_tree_from_leaves(leaves), device)
