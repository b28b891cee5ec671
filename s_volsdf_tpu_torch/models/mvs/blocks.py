"""Conv blocks and resampling for the MVS networks, NCHW / NCDHW
(counterpart of s_volsdf_tpu/models/mvs/blocks.py:83-258).

A block is conv + inference-mode BatchNorm + ReLU, the reference torch
Conv2d/Conv3d/Deconv2d/Deconv3d blocks: the modules are named `conv` and `bn`,
as in the reference state dicts. The MVS nets are frozen, so BN always
uses its stored statistics (eps 1e-5), whatever the module's mode.

The JAX package writes the transposed convs as input-dilated convs on
pre-flipped HWIO / DHWIO weights; here they are `nn.ConvTranspose2d` /
`nn.ConvTranspose3d` and the bridge flips the weights back (bridge.py).

The conv's precision follows its weight's dtype, as in the JAX package
(`_conv_operands`): `cast_conv_weights` rounds every conv kernel (not BN,
biases or linear layers) to bf16 once; a bf16 conv takes its input in
bf16 and hands a float32 output (bias added in float32) to BN and ReLU.
Its product is cuDNN's bf16 conv on the card (the CPU's on the CPU),
which rounds its output to bf16 where JAX's preferred_element_type=f32
does not: one more rounding of 2^-9 relative per conv (ROADMAP queue 3).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5


def _in_weight_dtype(conv: nn.Module, x: torch.Tensor, apply) -> torch.Tensor:
    """apply(x) in the conv weight's dtype: a bf16 weight takes x in bf16
    and returns float32 with the float32 bias added; a float32 weight
    runs as it is."""
    if conv.weight.dtype != torch.bfloat16:
        return apply(x, conv.bias)
    y = apply(x.to(torch.bfloat16), None).float()
    if conv.bias is not None:
        y = y + conv.bias.view((1, -1) + (1,) * (y.dim() - 2))
    return y


class Conv2d(nn.Conv2d):
    """nn.Conv2d in its weight's dtype (`_in_weight_dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _in_weight_dtype(
            self, x, lambda x, b: self._conv_forward(x, self.weight, b))


class Conv3d(nn.Conv3d):
    """nn.Conv3d in its weight's dtype (`_in_weight_dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _in_weight_dtype(
            self, x, lambda x, b: self._conv_forward(x, self.weight, b))


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d (fixed output_padding) in its weight's dtype
    (`_in_weight_dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _in_weight_dtype(self, x, lambda x, b: F.conv_transpose2d(
            x, self.weight, b, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation))


class ConvTranspose3d(nn.ConvTranspose3d):
    """nn.ConvTranspose3d (fixed output_padding) in its weight's dtype
    (`_in_weight_dtype`)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _in_weight_dtype(self, x, lambda x, b: F.conv_transpose3d(
            x, self.weight, b, self.stride, self.padding, self.output_padding,
            self.groups, self.dilation))


CONVS = (nn.Conv2d, nn.Conv3d, nn.ConvTranspose2d, nn.ConvTranspose3d)


def cast_conv_weights(net: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Every conv kernel of `net` in `dtype`, in place (biases, BN and
    any linear layer stay float32): the counterpart of the JAX
    `cast_conv_weights`, which casts every leaf of ndim >= 4. Kernels
    held as plain parameters (the deformable conv's (K*Cin, Cout)
    weight) are 2-D leaves there and stay float32 here."""
    for m in net.modules():
        if isinstance(m, CONVS):
            m.weight.data = m.weight.data.to(dtype)
    return net


@torch.no_grad()
def init_conv_weights(net: nn.Module, gen: torch.Generator) -> nn.Module:
    """Every conv kernel of `net` uniform in +-sqrt(1/fan_in) from `gen`
    (fan_in: input channels times the kernel's taps), every conv bias 0:
    the JAX package's distribution (`init_conv2d`, `init_conv3d`)."""
    for m in net.modules():
        if isinstance(m, CONVS):
            bound = math.sqrt(1.0 / (m.in_channels * math.prod(m.kernel_size)))
            m.weight.copy_(torch.rand(m.weight.shape, generator=gen)
                           * (2 * bound) - bound)
            if m.bias is not None:
                m.bias.zero_()
    return net


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
    return ConvBnReLU(Conv2d(cin, cout, k, stride, padding, bias=False),
                      nn.BatchNorm2d(cout, eps=BN_EPS))


def conv3d(cin: int, cout: int, k: int = 3, stride: int = 1,
           padding: int = 1) -> ConvBnReLU:
    return ConvBnReLU(Conv3d(cin, cout, k, stride, padding, bias=False),
                      nn.BatchNorm3d(cout, eps=BN_EPS))


def deconv2d(cin: int, cout: int, k: int = 3, stride: int = 2,
             padding: int = 1, output_padding: int = 1) -> ConvBnReLU:
    return ConvBnReLU(ConvTranspose2d(cin, cout, k, stride, padding,
                                      output_padding, bias=False),
                      nn.BatchNorm2d(cout, eps=BN_EPS))


def deconv3d(cin: int, cout: int, k: int = 3, stride: int = 2,
             padding: int = 1, output_padding: int = 1) -> ConvBnReLU:
    return ConvBnReLU(ConvTranspose3d(cin, cout, k, stride, padding,
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
