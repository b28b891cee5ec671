"""UCSNet, frozen inference (counterpart of
s_volsdf_tpu/models/mvs/ucsnet.py): CasMVSNet's cost-volume skeleton
with a UNet feature extractor (a transposed-conv-and-fuse pathway) and
hypothesis slabs sized by the previous stage's predicted depth spread.

Layouts are NCHW / NCDHW; one view's features are (C, H, W). Module
names follow the JAX pytree ({"feature": {...}, "cost_reg": [...]}), the
cost regularisation list being `cost_regularization` as in CasMVSNet
(bridge.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs.casmvsnet import CostRegNet, depth_net
from s_volsdf_tpu_torch.models.mvs.hypotheses import uncertainty_aware_samples

STAGE_SCALES = (4, 2, 1)


class DeconvFuse(nn.Module):
    """Deconv2dBlock: a stride-2 transposed conv block, concatenated with
    the finer level's features, then a 3x3 conv block."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.deconv = B.deconv2d(cin, cout)
        self.conv = B.conv2d(2 * cout, cout, 3, 1, 1)

    def forward(self, x_pre: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return self.conv(torch.cat([self.deconv(x), x_pre], dim=1))


class FeatExtNet(nn.Module):
    """The UNet pathway: (N, 3, H, W) -> stage1 (N, 4b, H/4, W/4), stage2
    (N, 2b, H/2, W/2), stage3 (N, b, H, W)."""

    def __init__(self, base: int = 8):
        super().__init__()
        b = base
        self.conv0 = nn.Sequential(B.conv2d(3, b, 3, 1, 1),
                                   B.conv2d(b, b, 3, 1, 1))
        self.conv1 = nn.Sequential(B.conv2d(b, 2 * b, 5, 2, 2),
                                   B.conv2d(2 * b, 2 * b, 3, 1, 1),
                                   B.conv2d(2 * b, 2 * b, 3, 1, 1))
        self.conv2 = nn.Sequential(B.conv2d(2 * b, 4 * b, 5, 2, 2),
                                   B.conv2d(4 * b, 4 * b, 3, 1, 1),
                                   B.conv2d(4 * b, 4 * b, 3, 1, 1))
        self.out1 = B.Conv2d(4 * b, 4 * b, 1, bias=False)
        self.deconv1 = DeconvFuse(4 * b, 2 * b)
        self.deconv2 = DeconvFuse(2 * b, b)
        self.out2 = B.Conv2d(2 * b, 2 * b, 1, bias=False)
        self.out3 = B.Conv2d(b, b, 1, bias=False)

    def forward(self, img: torch.Tensor) -> Dict[str, torch.Tensor]:
        c0 = self.conv0(img)
        c1 = self.conv1(c0)
        c2 = self.conv2(c1)
        outputs = {"stage1": self.out1(c2)}
        intra = self.deconv1(c1, c2)
        outputs["stage2"] = self.out2(intra)
        intra = self.deconv2(c0, intra)
        outputs["stage3"] = self.out3(intra)
        return outputs


class UCSNet(nn.Module):
    def __init__(self, stage_configs=(64, 32, 8), base_chs=(8, 8, 8),
                 feat_ext_ch: int = 8):
        super().__init__()
        out_chs = (feat_ext_ch * 4, feat_ext_ch * 2, feat_ext_ch)
        self.feature = FeatExtNet(feat_ext_ch)
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(out_chs[i], base_chs[i])
             for i in range(len(stage_configs))])


def init_ucsnet(gen: torch.Generator, stage_configs=(64, 32, 8),
                base_chs=(8, 8, 8), feat_ext_ch: int = 8,
                device=None) -> UCSNet:
    """Random frozen weights from `gen` with the JAX package's
    distribution (`blocks.init_conv_weights`; BN the identity)."""
    net = B.init_conv_weights(UCSNet(stage_configs, base_chs, feat_ext_ch),
                              gen)
    return net.to(device).eval().requires_grad_(False)


def compute_depth(cost_reg: CostRegNet, features: List[torch.Tensor],
                  proj_mats: torch.Tensor, depth_samps: torch.Tensor,
                  lamb: float) -> Dict[str, torch.Tensor]:
    """CasMVSNet's stage (variance volume, UNet, softmax, regression and
    confidence) plus "variance": lamb times the probability-weighted std
    of the hypotheses about the regressed depth, (H, W)."""
    out = depth_net(cost_reg, features, proj_mats, depth_samps)
    samp_variance = (depth_samps - out["depth"][None]) ** 2
    out["variance"] = lamb * torch.sqrt(
        torch.sum(samp_variance * out["prob_volume"], dim=0))
    return out


def ucsnet_features(net: UCSNet, imgs: torch.Tensor
                    ) -> List[Dict[str, torch.Tensor]]:
    """Per-view pyramids of imgs (V, 3, H, W), batched over views."""
    stacked = net.feature(imgs)
    return [{k: v[i] for k, v in stacked.items()}
            for i in range(imgs.shape[0])]


def ucsnet_stage(net: UCSNet, stage_idx: int,
                 features: List[Dict[str, torch.Tensor]],
                 proj_mats: torch.Tensor, depth_values_range: torch.Tensor,
                 prev_depth: Optional[torch.Tensor],
                 prev_variance: Optional[torch.Tensor],
                 img_hw: Tuple[int, int], stage_configs=(64, 32, 8),
                 lamb: float = 1.5,
                 inverse_depth: bool = False) -> Dict[str, torch.Tensor]:
    """One stage. prev_depth and prev_variance (the runner's `extra`)
    come from the previous stage (prev_depth after a VolSDF budget is
    its feedback render); both are resized bilinearly to the stage."""
    H, W = img_hw
    scale = STAGE_SCALES[stage_idx]
    cur_h, cur_w = H // scale, W // scale
    if prev_depth is not None:
        cur_depth = B.interpolate_bilinear(prev_depth[None, None],
                                           (cur_h, cur_w))[0, 0]
        exp_var = B.interpolate_bilinear(prev_variance[None, None],
                                         (cur_h, cur_w))[0, 0]
    else:
        cur_depth, exp_var = depth_values_range, None
    depth_samps = uncertainty_aware_samples(
        cur_depth, exp_var, stage_configs[stage_idx], (cur_h, cur_w),
        inverse_depth=inverse_depth)
    feats_stage = [f[f"stage{stage_idx + 1}"] for f in features]
    return compute_depth(net.cost_regularization[stage_idx], feats_stage,
                         proj_mats, depth_samps, lamb)
