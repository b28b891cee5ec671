"""CascadeMVSNet, frozen inference (counterpart of
s_volsdf_tpu/models/mvs/casmvsnet.py:38-299): FPN feature pyramid,
variance cost volume over homography-warped source features, 3D-UNet
cost regularization, softmax probability volume, depth regression with
the 4-window photometric confidence, and the 3-stage coarse-to-fine
hypothesis cascade.

`FeatureNet` and `CostRegNet` (the unpacked UNet) are the JAX
`feature_net` and `cost_reg_net`. Layouts are NCHW / NCDHW; one view's
features are (C, H, W). Module names follow the reference torch model's
state dict (`feature.conv0.0.conv.weight`,
`cost_regularization.0.conv7.conv.weight`, ...); the JAX pytree's
"cost_reg" list is `cost_regularization` here (bridge.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs.hypotheses import (
    depth_range_samples, depth_range_samples_inverse)
from s_volsdf_tpu_torch.models.mvs.warp import _proj_grid, sample_grid

STAGE_SCALES = (4, 2, 1)


class FeatureNet(nn.Module):
    """The FPN: (N, 3, H, W) -> stage1 (N, 4b, H/4, W/4), stage2
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
        self.inner1 = B.Conv2d(2 * b, 4 * b, 1, bias=True)
        self.inner2 = B.Conv2d(b, 4 * b, 1, bias=True)
        self.out2 = B.Conv2d(4 * b, 2 * b, 3, padding=1, bias=False)
        self.out3 = B.Conv2d(4 * b, b, 3, padding=1, bias=False)

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


class CostRegNet(nn.Module):
    """The 3-level 3D UNet: (N, C, D, H, W) variance -> (N, D, H, W)
    logits. D, H and W must be multiples of 8."""

    def __init__(self, cin: int, base: int = 8):
        super().__init__()
        b = base
        self.conv0 = B.conv3d(cin, b)
        self.conv1 = B.conv3d(b, 2 * b, stride=2)
        self.conv2 = B.conv3d(2 * b, 2 * b)
        self.conv3 = B.conv3d(2 * b, 4 * b, stride=2)
        self.conv4 = B.conv3d(4 * b, 4 * b)
        self.conv5 = B.conv3d(4 * b, 8 * b, stride=2)
        self.conv6 = B.conv3d(8 * b, 8 * b)
        self.conv7 = B.deconv3d(8 * b, 4 * b)
        self.conv9 = B.deconv3d(4 * b, 2 * b)
        self.conv11 = B.deconv3d(2 * b, b)
        self.prob = B.Conv3d(b, 1, 3, 1, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c0 = self.conv0(x)
        c2 = self.conv2(self.conv1(c0))
        c4 = self.conv4(self.conv3(c2))
        h = self.conv6(self.conv5(c4))
        h = c4 + self.conv7(h)
        h = c2 + self.conv9(h)
        h = c0 + self.conv11(h)
        return self.prob(h)[:, 0]


class CasMVSNet(nn.Module):
    def __init__(self, ndepths=(192, 32, 8), base: int = 8,
                 cr_base_chs=(8, 8, 8)):
        super().__init__()
        out_chs = (base * 4, base * 2, base)
        self.feature = FeatureNet(base)
        self.cost_regularization = nn.ModuleList(
            [CostRegNet(out_chs[i], cr_base_chs[i])
             for i in range(len(ndepths))])


def init_casmvsnet(gen: torch.Generator, ndepths=(192, 32, 8),
                   base: int = 8, cr_base_chs=(8, 8, 8),
                   device=None) -> CasMVSNet:
    """Random frozen weights from `gen` (a CPU generator, so a seed
    gives the same weights on every device), with the JAX package's
    distribution: kernels uniform in +-sqrt(1/fan_in), biases 0, BN the
    identity (scale 1, shift 0, mean 0, var 1)."""
    net = B.init_conv_weights(CasMVSNet(ndepths, base, cr_base_chs), gen)
    return net.to(device).eval().requires_grad_(False)


def _compose(pm: torch.Tensor) -> torch.Tensor:
    """[K @ [R | t]; 0 0 0 1] from a (2, 4, 4) [extrinsic, K] pair."""
    out = pm[0].clone()
    out[:3, :4] = pm[1][:3, :3] @ pm[0][:3, :4]
    return out


def variance_volume(features: Sequence[torch.Tensor], proj_mats: torch.Tensor,
                    depth_values: torch.Tensor,
                    depth_chunk: int = 16) -> torch.Tensor:
    """Variance of the reference and the warped source features over
    views, (C, D, H, W), built `depth_chunk` hypotheses at a time from a
    running sum and sum of squares: no chunk holds more than three
    (C, chunk, H, W) temporaries.

    features: V (C, H, W) maps, reference first; proj_mats: (V, 2, 4, 4);
    depth_values: (D, H, W)."""
    num_views = len(features)
    ref, srcs = features[0], features[1:]
    C, H, W = ref.shape
    D = depth_values.shape[0]
    ref_proj = _compose(proj_mats[0])
    src_projs = [_compose(proj_mats[i + 1]) for i in range(len(srcs))]
    chunk = min(depth_chunk, D)
    while D % chunk:
        chunk -= 1
    var = torch.empty((C, D, H, W), dtype=ref.dtype, device=ref.device)
    for d0 in range(0, D, chunk):
        dv = depth_values[d0:d0 + chunk]
        ref_block = ref[:, None].expand(C, chunk, H, W)
        s = ref_block
        sq = ref_block ** 2
        for src, src_proj in zip(srcs, src_projs):
            grid, _ = _proj_grid(src_proj, ref_proj, dv, H, W)
            w = sample_grid(src, grid)
            s = s + w
            sq = sq + w ** 2
        var[:, d0:d0 + chunk] = sq / num_views - (s / num_views) ** 2
    return var


def depth_net(cost_reg: CostRegNet, features: Sequence[torch.Tensor],
              proj_mats: torch.Tensor, depth_values: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """One stage: variance volume -> UNet -> softmax over depth ->
    regressed depth and photometric confidence (the probability mass of
    the 4-hypothesis window at the truncated expected index)."""
    D = depth_values.shape[0]
    variance = variance_volume(features, proj_mats, depth_values)
    logits = cost_reg(variance[None])[0]                      # (D, H, W)
    del variance
    prob_volume = torch.softmax(logits, dim=0)
    depth = torch.sum(prob_volume * depth_values, dim=0)
    sum4 = B.avg_pool3d_depth_win4(prob_volume[None])[0]
    steps = torch.arange(D, dtype=prob_volume.dtype,
                         device=prob_volume.device)[:, None, None]
    depth_index = torch.sum(prob_volume * steps, dim=0).to(torch.int64)
    depth_index = torch.clamp(depth_index, 0, D - 1)
    confidence = torch.gather(sum4, 0, depth_index[None])[0]
    return {"depth": depth, "photometric_confidence": confidence,
            "prob_volume": prob_volume, "depth_values": depth_values}


def casmvsnet_features(net: CasMVSNet, imgs: torch.Tensor
                       ) -> List[Dict[str, torch.Tensor]]:
    """Per-view feature pyramids of imgs (V, 3, H, W), batched over
    views in one pass. Returns V dicts of (C, h, w) maps."""
    stacked = net.feature(imgs)
    return [{k: v[i] for k, v in stacked.items()}
            for i in range(imgs.shape[0])]


def casmvsnet_stage(net: CasMVSNet, stage_idx: int,
                    features: List[Dict[str, torch.Tensor]],
                    proj_mats: torch.Tensor,
                    depth_values_range: torch.Tensor,
                    prev_depth: Optional[torch.Tensor],
                    img_hw: Tuple[int, int], ndepths=(192, 32, 8),
                    depth_inter_r=(1.0, 0.5, 0.5),
                    inverse_depth: bool = False) -> Dict[str, torch.Tensor]:
    """One cascade stage.

    features: V per-view pyramids (reference first); proj_mats:
    (V, 2, 4, 4) for this stage; depth_values_range: (D0,) the scene's
    depth range samples; prev_depth: (h, w) depth of the previous stage
    (or the VolSDF feedback) or None; img_hw: full-resolution (H, W).
    """
    H, W = img_hw
    scale = STAGE_SCALES[stage_idx]
    depth_min = depth_values_range[0]
    depth_max = depth_values_range[-1]
    # The range's length over D0, not D0 - 1, as the reference does.
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
    feats_stage = [f[f"stage{stage_idx + 1}"] for f in features]
    return depth_net(net.cost_regularization[stage_idx], feats_stage,
                     proj_mats, depth_values)
