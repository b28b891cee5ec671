"""The port's MVS blocks, hypothesis samplers and homography warp
against the JAX package's (s_volsdf_tpu/models/mvs/{blocks,hypotheses,
warp}.py), on the same numpy inputs and weights.

Tolerance atol 1e-5 for the conv blocks (BN with random statistics),
the interpolations, the warp and the samplers in unit-sized ranges;
rtol 1e-6 for the samplers on DTU-sized depths (~425-905). The JAX
layouts are channels-last, the port's channels-first: the tests
transpose.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.models.mvs import blocks as JB
from s_volsdf_tpu.models.mvs import hypotheses as JH
from s_volsdf_tpu.models.mvs.warp import homo_warping as jhomo_warping
from s_volsdf_tpu.models.mvs.warp import _proj_grid as j_proj_grid
from s_volsdf_tpu_torch.bridge import load_conv
from s_volsdf_tpu_torch.models.mvs import blocks as TB
from s_volsdf_tpu_torch.models.mvs import hypotheses as TH
from s_volsdf_tpu_torch.models.mvs.warp import homo_warping

ATOL = 1e-5


def _leaf(rng, kshape, cin, cout, bn, bias):
    """A JAX conv leaf with random kernel, bias and BN statistics."""
    p = {"w": rng.normal(size=kshape + (cin, cout)).astype(np.float32)
         / np.sqrt(cin * np.prod(kshape))}
    if bias:
        p["b"] = rng.normal(size=cout).astype(np.float32)
    if bn:
        p["bn"] = {"scale": rng.uniform(0.5, 1.5, cout).astype(np.float32),
                   "bias": rng.normal(size=cout).astype(np.float32),
                   "mean": rng.normal(size=cout).astype(np.float32),
                   "var": rng.uniform(0.5, 2.0, cout).astype(np.float32)}
    return p


def _jax(p):
    return {k: (_jax(v) if isinstance(v, dict) else jnp.asarray(v))
            for k, v in p.items()}


@pytest.mark.parametrize("k,stride,padding,bn,bias,relu", [
    (3, 1, 1, True, False, True),
    (5, 2, 2, True, False, True),
    (1, 1, 0, False, True, False),
    (3, 2, 1, False, False, False),
])
def test_conv2d_matches_jax(k, stride, padding, bn, bias, relu):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 12, 16, 5)).astype(np.float32)
    p = _leaf(rng, (k, k), 5, 7, bn, bias)
    want = JB.conv2d(_jax(p), jnp.asarray(x), stride=stride,
                     padding=padding, relu=relu)
    # Without BN the port's conv is a plain nn.Conv2d, as the FPN's
    # lateral and output convs are.
    block = TB.conv2d(5, 7, k, stride, padding) if bn \
        else torch.nn.Conv2d(5, 7, k, stride, padding, bias=bias)
    load_conv(block, p)
    got = block(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stride,bn,relu", [(1, True, True), (2, True, True),
                                            (1, False, False)])
def test_conv3d_matches_jax(stride, bn, relu):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(1, 8, 8, 12, 4)).astype(np.float32)
    p = _leaf(rng, (3, 3, 3), 4, 6, bn, False)
    want = JB.conv3d(_jax(p), jnp.asarray(x), stride=stride, relu=relu)
    # Without BN: a plain nn.Conv3d, as the UNet's probability head.
    block = TB.conv3d(4, 6, stride=stride) if bn \
        else torch.nn.Conv3d(4, 6, 3, stride, 1, bias=False)
    load_conv(block, p)
    got = block(torch.tensor(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.permute(0, 2, 3, 4, 1).detach().numpy(),
                               np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("stride,output_padding", [(2, 1), (1, 0)])
def test_deconv3d_matches_jax(stride, output_padding):
    """The input-dilated conv on pre-flipped DHWIO weights against
    ConvTranspose3d on the bridged (flipped back) weights."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(1, 4, 6, 8, 6)).astype(np.float32)
    p = _leaf(rng, (3, 3, 3), 6, 3, True, False)
    want = JB.deconv3d(_jax(p), jnp.asarray(x), stride=stride,
                       output_padding=output_padding)
    block = TB.deconv3d(6, 3, stride=stride, output_padding=output_padding)
    load_conv(block, p)
    got = block(torch.tensor(x).permute(0, 4, 1, 2, 3))
    got = got.permute(0, 2, 3, 4, 1).detach().numpy()
    assert got.shape == np.asarray(want).shape
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)


def test_upsample2x_nearest_matches_jax():
    x = np.random.default_rng(3).normal(size=(2, 5, 7, 3)).astype(np.float32)
    want = JB.upsample2x_nearest(jnp.asarray(x))
    got = TB.upsample2x_nearest(torch.tensor(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("in_hw,out_hw", [
    ((16, 24), (64, 96)),    # x4: stage 1 -> full resolution
    ((32, 48), (64, 96)),    # x2
    ((64, 96), (32, 48)),
    ((10, 14), (23, 31)),    # a scale that is not an integer
])
def test_interpolate_bilinear_matches_jax(in_hw, out_hw):
    """Upsampling by 4 puts the first output rows' source coordinate
    below 0 (-0.375): both clamp it to the first row."""
    x = np.random.default_rng(4).uniform(400, 900, size=(1,) + in_hw + (2,))
    x = x.astype(np.float32)
    want = JB.interpolate_bilinear(jnp.asarray(x), out_hw,
                                   align_corners=False)
    got = TB.interpolate_bilinear(torch.tensor(x).permute(0, 3, 1, 2),
                                  out_hw)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("in_shape,out_shape", [
    ((16, 64, 96), (16, 16, 24)),    # stage 1: full-res hypotheses / 4
    ((8, 64, 96), (8, 32, 48)),
    ((8, 12, 16), (16, 24, 32)),
])
def test_interpolate_trilinear_depth_matches_jax(in_shape, out_shape):
    vol = np.random.default_rng(5).uniform(400, 900, size=(1,) + in_shape)
    vol = vol.astype(np.float32)
    want = JB.interpolate_trilinear_depth(jnp.asarray(vol), out_shape)
    got = TB.interpolate_trilinear_depth(torch.tensor(vol), out_shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_avg_pool3d_depth_win4_matches_jax():
    p = np.random.default_rng(6).uniform(size=(1, 12, 5, 7)).astype(np.float32)
    want = JB.avg_pool3d_depth_win4(jnp.asarray(p))
    got = TB.avg_pool3d_depth_win4(torch.tensor(p))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["depth_range_samples",
                                  "depth_range_samples_inverse"])
@pytest.mark.parametrize("per_pixel", [False, True])
def test_hypothesis_samplers_match_jax(name, per_pixel):
    """Both first-stage spans of a (D0,) range and the per-pixel window
    (cur_depth_range_samples) behind both."""
    rng = np.random.default_rng(7)
    if per_pixel:
        cur = rng.uniform(450, 880, size=(12, 16)).astype(np.float32)
    else:
        cur = np.arange(425.0, 2.65 * 191.5 + 425.0, 2.65, dtype=np.float32)
    interval = np.float32(0.5 * (cur.max() - cur.min()) / 192)
    want = getattr(JH, name)(jnp.asarray(cur), 8, jnp.asarray(interval),
                             (12, 16))
    got = getattr(TH, name)(torch.tensor(cur), 8, torch.tensor(interval),
                            (12, 16))
    assert got.shape == (8, 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_cur_depth_range_samples_matches_jax():
    cur = np.random.default_rng(8).uniform(1, 4, size=(6, 9))
    cur = cur.astype(np.float32)
    want = JH.cur_depth_range_samples(jnp.asarray(cur), 16, 0.01)
    got = TH.cur_depth_range_samples(torch.tensor(cur), 16, 0.01)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _warp_inputs():
    """A reference and a source camera 12x16 apart by a rotation and a
    translation, so part of each depth plane warps outside the source."""
    rng = np.random.default_rng(9)
    H, W, C, D = 12, 16, 8, 8
    K = np.eye(4, dtype=np.float32)
    K[0, 0] = K[1, 1] = 14.0
    K[0, 2], K[1, 2] = W / 2, H / 2
    a = 0.15
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]], np.float32)
    E = np.eye(4, dtype=np.float32)
    E[:3, :3] = R
    E[:3, 3] = [-0.6, 0.1, 0.2]
    ref_proj = K.copy()
    src_proj = (K @ E).astype(np.float32)
    src = rng.normal(size=(H, W, C)).astype(np.float32)
    depth = np.linspace(2.0, 6.0, D, dtype=np.float32)
    per_pixel = depth[:, None, None] + rng.uniform(
        -0.2, 0.2, size=(D, H, W)).astype(np.float32)
    return src, src_proj, ref_proj, depth, per_pixel


@pytest.mark.parametrize("per_pixel", [False, True])
def test_homo_warping_matches_jax(per_pixel):
    src, src_proj, ref_proj, depth, dpix = _warp_inputs()
    dv = dpix if per_pixel else depth
    grid, _ = j_proj_grid(jnp.asarray(src_proj), jnp.asarray(ref_proj),
                          jnp.asarray(dv), 12, 16)
    outside = np.mean(np.any(np.abs(np.asarray(grid)) > 1.0, axis=-1))
    assert 0.05 < outside < 0.95, outside
    want = jhomo_warping(jnp.asarray(src), jnp.asarray(src_proj),
                         jnp.asarray(ref_proj), jnp.asarray(dv),
                         align_corners=False)
    got = homo_warping(torch.tensor(src).permute(2, 0, 1),
                       torch.tensor(src_proj), torch.tensor(ref_proj),
                       torch.tensor(dv))
    assert got.shape == (8, 8, 12, 16)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(),
                               np.asarray(want), atol=ATOL)
