"""TransMVSNet, frozen inference (counterpart of
s_volsdf_tpu/models/mvs/transmvsnet.py): an FPN whose three heads end in
deformable convs (`ops/deform_conv.py`, a CUDA kernel on the card), the
FMT transformer (fmt.py), a dot-product similarity volume per source
view weighted by PixelwiseNet's per-pixel visibility, a 1-channel
CostRegNet per stage and winner-take-all depth.

Layouts are NCHW / NCDHW; one view's features are (C, H, W). Module
names follow the JAX pytree ({"feature", "fmt", "pixelwise",
"cost_reg"}), the cost regularisation list being `cost_regularization`
(bridge.py). The DCN's main weight is a plain (9 * Cin, Cout) tap-major
parameter, so `blocks.cast_conv_weights` leaves it float32, as JAX's
ndim >= 4 rule does; its offset-and-mask conv is a conv and is cast.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs.casmvsnet import CostRegNet, _compose
from s_volsdf_tpu_torch.models.mvs.fmt import (FMTWithPathway,
                                               fmt_with_pathway,
                                               init_fmt_with_pathway)
from s_volsdf_tpu_torch.models.mvs.hypotheses import (
    depth_range_samples, depth_range_samples_inverse)
from s_volsdf_tpu_torch.models.mvs.warp import homo_warping
from s_volsdf_tpu_torch.ops.deform_conv import TAPS, deform_conv2d_batch

STAGE_SCALES = (4, 2, 1)
SIMILARITY_CHUNK = 16     # depth planes warped at a time


class DCN(nn.Module):
    """Offset-and-mask conv (3x3, 27 channels), then the modulated
    deformable conv. The offset conv's output splits into o1, o2 and the
    mask logits; the offsets are cat(o1, o2), read as (dy, dx) pairs per
    tap, which is torchvision's reading: dy_k is channel 2k and dx_k
    channel 2k + 1 of the first 18."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.offset_conv = B.Conv2d(cin, 3 * TAPS, 3, padding=1, bias=True)
        self.w = nn.Parameter(torch.zeros(TAPS * cin, cout))
        self.b = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (N, Cin, H, W) -> (N, Cout, H, W): the deformable convs of
        the N images in one kernel launch on the card."""
        om = self.offset_conv(x)
        offset = om[:, :2 * TAPS].contiguous()
        mask = torch.sigmoid(om[:, 2 * TAPS:]).contiguous()
        return deform_conv2d_batch(x.contiguous(), offset, mask, self.w,
                                   self.b)


class DCNHead(nn.Module):
    """conv block, then DCN-BN-ReLU twice and a final DCN."""

    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.conv = B.conv2d(cin, cin, k, 1, k // 2)
        self.dcn1 = DCN(cin, cin)
        self.bn1 = nn.BatchNorm2d(cin, eps=B.BN_EPS)
        self.dcn2 = DCN(cin, cin)
        self.bn2 = nn.BatchNorm2d(cin, eps=B.BN_EPS)
        self.dcn3 = DCN(cin, cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv(x)
        for dcn, bn in ((self.dcn1, self.bn1), (self.dcn2, self.bn2)):
            h = F.relu(F.batch_norm(dcn(h), bn.running_mean, bn.running_var,
                                    bn.weight, bn.bias, training=False,
                                    eps=B.BN_EPS))
        return self.dcn3(h)


class TransFeatureNet(nn.Module):
    """(N, 3, H, W) -> stage1 (N, 4b, H/4, W/4), stage2 (N, 2b, H/2,
    W/2), stage3 (N, b, H, W), each through a DCN head."""

    def __init__(self, base: int = 8):
        super().__init__()
        b, fc = base, base * 4
        self.conv0 = nn.Sequential(B.conv2d(3, b, 3, 1, 1),
                                   B.conv2d(b, b, 3, 1, 1))
        self.conv1 = nn.Sequential(B.conv2d(b, 2 * b, 5, 2, 2),
                                   B.conv2d(2 * b, 2 * b, 3, 1, 1),
                                   B.conv2d(2 * b, 2 * b, 3, 1, 1))
        self.conv2 = nn.Sequential(B.conv2d(2 * b, fc, 5, 2, 2),
                                   B.conv2d(fc, fc, 3, 1, 1),
                                   B.conv2d(fc, fc, 3, 1, 1))
        self.out1 = DCNHead(fc, fc, 1)
        self.inner1 = B.Conv2d(2 * b, fc, 1, bias=True)
        self.inner2 = B.Conv2d(b, fc, 1, bias=True)
        self.out2 = DCNHead(fc, 2 * b, 3)
        self.out3 = DCNHead(fc, b, 3)

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        c0 = self.conv0(img)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        outputs = {"stage1": self.out1(c2)}
        intra = B.upsample2x_nearest(c2) + self.inner1(c1)
        outputs["stage2"] = self.out2(intra)
        intra = B.upsample2x_nearest(intra) + self.inner2(c0)
        outputs["stage3"] = self.out3(intra)
        return outputs


class PixelwiseNet(nn.Module):
    """Three 1x1x1 conv layers (1 -> 16 -> 8 -> 1) over the similarity
    volume, applied as products over the channel axis."""

    def __init__(self):
        super().__init__()
        self.conv0 = B.conv3d(1, 16, 1, 1, 0)
        self.conv1 = B.conv3d(16, 8, 1, 1, 0)
        self.conv2 = B.Conv3d(8, 1, 1, bias=True)


class TransMVSNet(nn.Module):
    def __init__(self, ndepths=(192, 32, 8), base: int = 8,
                 cr_base_chs=(8, 8, 8)):
        super().__init__()
        self.feature = TransFeatureNet(base)
        self.fmt = FMTWithPathway(base)
        self.pixelwise = PixelwiseNet()
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(1, cr_base_chs[i]) for i in range(len(ndepths))])


@torch.no_grad()
def init_transmvsnet(gen: torch.Generator, ndepths=(192, 32, 8),
                     base: int = 8, cr_base_chs=(8, 8, 8),
                     device=None) -> TransMVSNet:
    """Random frozen weights from `gen` with the JAX package's
    distribution: convs as `blocks.init_conv_weights`, the DCNs' offset
    convs zero (a DCN starts as a plain conv) and main weights uniform in
    +-1/sqrt(9 Cin), the FMT's linears xavier-uniform, BN and LayerNorm
    the identity."""
    net = B.init_conv_weights(TransMVSNet(ndepths, base, cr_base_chs), gen)
    init_fmt_with_pathway(net.fmt, gen)
    for m in net.modules():
        if isinstance(m, DCN):
            m.offset_conv.weight.zero_()
            m.offset_conv.bias.zero_()
            bound = 1.0 / math.sqrt(m.w.shape[0])
            m.w.copy_(torch.rand(m.w.shape, generator=gen) * (2 * bound)
                      - bound)
    return net.to(device).eval().requires_grad_(False)


def _dense(block: nn.Module, x: torch.Tensor, relu: bool = True):
    """A 1x1x1 conv (block) on channel-last x, as the JAX `x @ w`: a
    bf16 kernel is promoted to float32 and the product taken in
    float32; BN as JAX folds it."""
    conv, bn = (block.conv, block.bn) if isinstance(block, B.ConvBnReLU) \
        else (block, None)
    w = conv.weight.float().reshape(conv.out_channels, conv.in_channels).T
    y = x @ w
    if conv.bias is not None:
        y = y + conv.bias
    if bn is not None:
        inv = bn.weight * torch.rsqrt(bn.running_var + B.BN_EPS)
        y = y * inv + (bn.bias - bn.running_mean * inv)
    return torch.relu(y) if relu else y


def pixelwise_net(net: PixelwiseNet, similarity: torch.Tensor) -> torch.Tensor:
    """similarity (D, H, W) -> per-pixel visibility weight (H, W): the
    max over depth of the sigmoid of the 1x1x1 stack."""
    x = _dense(net.conv0, similarity[..., None])
    x = _dense(net.conv1, x)
    x = _dense(net.conv2, x, relu=False)
    return torch.sigmoid(x[..., 0]).max(dim=0).values


def trans_depth_net(cost_reg: CostRegNet, pw: PixelwiseNet,
                    features: List[torch.Tensor], proj_mats: torch.Tensor,
                    depth_values: torch.Tensor,
                    view_weights: Optional[torch.Tensor]
                    ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """One stage: per source view, the similarity (mean over channels of
    the warped source times the reference) built SIMILARITY_CHUNK planes
    at a time with PixelwiseNet per chunk (its max over depth commutes
    with the chunking); the views averaged with their visibility weights
    (given, or this stage's own when `view_weights` is None), then the
    UNet, softmax, winner-take-all depth and max-probability confidence.
    Returns (outputs, view_weights (V-1, H, W))."""
    D = depth_values.shape[0]
    ref_feature, src_features = features[0], features[1:]
    ref_proj = _compose(proj_mats[0])
    chunk = min(SIMILARITY_CHUNK, D)
    while D % chunk:
        chunk -= 1

    similarity_sum = 0.0
    weight_sum = 1e-5
    new_weights = []
    for i, src_fea in enumerate(src_features):
        src_proj = _compose(proj_mats[i + 1])
        sims, pws = [], []
        for d0 in range(0, D, chunk):
            warped = homo_warping(src_fea, src_proj, ref_proj,
                                  depth_values[d0:d0 + chunk],
                                  align_corners=True, mask_behind=True)
            sim_c = torch.mean(warped * ref_feature[:, None], dim=0)
            del warped
            sims.append(sim_c)
            pws.append(pixelwise_net(pw, sim_c))
        similarity = torch.cat(sims)                     # (D, H, W)
        vw_new = torch.stack(pws).max(dim=0).values      # (H, W)
        if view_weights is None:
            vw = vw_new
            new_weights.append(vw)
        else:
            vw = view_weights[i]
        similarity_sum = similarity_sum + similarity * vw[None]
        weight_sum = weight_sum + vw[None]
    similarity = similarity_sum / weight_sum

    logits = cost_reg(similarity[None, None])[0]         # (D, H, W)
    prob_volume = torch.softmax(logits, dim=0)
    wta = torch.argmax(prob_volume, dim=0)
    depth = torch.gather(depth_values, 0, wta[None])[0]
    confidence = prob_volume.max(dim=0).values
    out = {"depth": depth, "photometric_confidence": confidence,
           "prob_volume": prob_volume, "depth_values": depth_values}
    if view_weights is None:
        view_weights = torch.stack(new_weights)
    return out, view_weights


def trans_feature_net(net: TransFeatureNet, imgs: torch.Tensor
                      ) -> List[Dict[str, torch.Tensor]]:
    """The DCN backbone's pyramids of imgs (V, 3, H, W), one view at a
    time (nine deformable-conv launches a view)."""
    out = []
    for v in range(imgs.shape[0]):
        f = net(imgs[v:v + 1])
        out.append({k: t[0] for k, t in f.items()})
    return out


def transmvsnet_features(net: TransMVSNet, imgs: torch.Tensor
                         ) -> List[Dict[str, torch.Tensor]]:
    """Backbone pyramids, then the FMT pathway with view 0 as the
    reference."""
    return fmt_with_pathway(net.fmt, trans_feature_net(net.feature, imgs))


def transmvsnet_stage(net: TransMVSNet, stage_idx: int,
                      features: List[Dict[str, torch.Tensor]],
                      proj_mats: torch.Tensor,
                      depth_values_range: torch.Tensor,
                      prev_depth: Optional[torch.Tensor],
                      view_weights: Optional[torch.Tensor],
                      img_hw: Tuple[int, int], ndepths=(192, 32, 8),
                      depth_inter_r=(1.0, 0.5, 0.5),
                      inverse_depth: bool = False):
    """One stage. The hypotheses are made at full resolution (H, W)
    around the previous depth, then resized trilinearly to the stage;
    the previous stage's view weights (the runner's `extra`) are
    upsampled 2x, nearest. Returns (outputs, view_weights)."""
    H, W = img_hw
    scale = STAGE_SCALES[stage_idx]
    depth_min = depth_values_range[0]
    depth_max = depth_values_range[-1]
    depth_interval = (depth_max - depth_min) / depth_values_range.shape[0]
    if prev_depth is not None:
        cur_depth = B.interpolate_bilinear(prev_depth[None, None],
                                           (H, W))[0, 0]
    else:
        cur_depth = depth_values_range
    gen = depth_range_samples_inverse if inverse_depth \
        else depth_range_samples
    drs = gen(cur_depth, ndepths[stage_idx],
              depth_inter_r[stage_idx] * depth_interval, (H, W))
    depth_values = B.interpolate_trilinear_depth(
        drs[None], (ndepths[stage_idx], H // scale, W // scale))[0]
    if stage_idx > 0 and view_weights is not None:
        view_weights = B.upsample2x_nearest(view_weights[:, None])[:, 0]
    feats_stage = [f[f"stage{stage_idx + 1}"] for f in features]
    return trans_depth_net(net.cost_regularization[stage_idx], net.pixelwise,
                           feats_stage, proj_mats, depth_values, view_weights)
