"""Conv blocks and resampling for the MVS networks, NCHW / NCDHW
(counterpart of s_volsdf_tpu/models/mvs/blocks.py:83-258).

A block is conv + inference-mode BatchNorm + ReLU, the reference torch
Conv2d/Conv3d/Deconv3d blocks: the modules are named `conv` and `bn`,
as in the reference state dicts. The MVS nets are frozen, so BN always
uses its stored statistics (eps 1e-5), whatever the module's mode.

The JAX package writes the transposed conv as an input-dilated conv on
pre-flipped DHWIO weights; here it is `nn.ConvTranspose3d` and the
bridge flips the weights back (bridge.py).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


class ConvBnReLU(nn.Module):
    """conv -> BN (stored statistics) -> ReLU."""

    def __init__(self, conv: nn.Module, bn: nn.Module):
        super().__init__()
        self.conv = conv
        self.bn = bn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.batch_norm(self.conv(x), self.bn.running_mean,
                         self.bn.running_var, self.bn.weight, self.bn.bias,
                         training=False, eps=BN_EPS)
        return F.relu(y)


def conv2d(cin: int, cout: int, k: int, stride: int = 1,
           padding: int = 0) -> ConvBnReLU:
    return ConvBnReLU(nn.Conv2d(cin, cout, k, stride, padding, bias=False),
                      nn.BatchNorm2d(cout, eps=BN_EPS))


def conv3d(cin: int, cout: int, k: int = 3, stride: int = 1,
           padding: int = 1) -> ConvBnReLU:
    return ConvBnReLU(nn.Conv3d(cin, cout, k, stride, padding, bias=False),
                      nn.BatchNorm3d(cout, eps=BN_EPS))


def deconv3d(cin: int, cout: int, k: int = 3, stride: int = 2,
             padding: int = 1, output_padding: int = 1) -> ConvBnReLU:
    return ConvBnReLU(nn.ConvTranspose3d(cin, cout, k, stride, padding,
                                         output_padding, bias=False),
                      nn.BatchNorm3d(cout, eps=BN_EPS))


def upsample2x_nearest(x: torch.Tensor) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, 2H, 2W), nearest."""
    return F.interpolate(x, scale_factor=2, mode="nearest")


def interpolate_bilinear(x: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N, C, H, W) -> (N, C, OH, OW), align_corners=False: a source
    coordinate below 0 clamps to 0, as the JAX version's clipped index
    and weight do."""
    return F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                         align_corners=False)


def interpolate_trilinear_depth(vol: torch.Tensor,
                                out_shape) -> torch.Tensor:
    """(N, D, H, W) single-channel volumes -> (N, OD, OH, OW),
    align_corners=False."""
    return F.interpolate(vol[:, None], size=tuple(out_shape),
                         mode="trilinear", align_corners=False)[:, 0]


def avg_pool3d_depth_win4(prob: torch.Tensor) -> torch.Tensor:
    """Sliding sum of 4 along depth with padding (1, 2): the
    4-hypothesis photometric-confidence window. (N, D, H, W) -> same."""
    padded = F.pad(prob, (0, 0, 0, 0, 1, 2))
    return (padded[:, 0:-3] + padded[:, 1:-2]
            + padded[:, 2:-1] + padded[:, 3:])
