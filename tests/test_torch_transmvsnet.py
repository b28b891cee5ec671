"""The port's TransMVSNet (s_volsdf_tpu_torch/models/mvs/transmvsnet.py,
fmt.py) against the JAX package's (s_volsdf_tpu/models/mvs/
transmvsnet.py, fmt.py), with the weights of `init_transmvsnet(
PRNGKey(0))` made lively (`lively_mvs_tree`: random BN and LayerNorm,
He's gain, random DCN offset convs, since at init they are zero and a
DCN is a plain conv) bridged into the port: three 64x64 views, ndepths
(16, 8, 8).

Bars: features, the FMT's pieces and PixelwiseNet within 1e-5 relative
to their scale (float32 sums in another order); the deformable conv 1e-5
absolute at unit-scale inputs; the MVS volumes 1e-5 (README "Verified
parity"): prob_volume and confidence 1e-5 absolute, the hypotheses 1e-5
relative. Winner-take-all depth: argmax may pick either of two
hypotheses whose probabilities are within the bar, so the hypothesis
index is compared exactly, and the depth within 1e-6 relative (the two
packages' hypotheses), on the pixels whose top two probabilities differ
by more than 1e-5 (at least half of them). One stage at the JAX defaults
(bf16 convs): see `test_stage_bf16_matches_jax`. The bridge's round trip
and the converted-checkpoint load are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s_volsdf_tpu.data.synthetic import make_sphere_scene
from s_volsdf_tpu.models.mvs import fmt as JF
from s_volsdf_tpu.models.mvs import transmvsnet as J
from s_volsdf_tpu.models.mvs.warp import homo_warping as jhomo_warping
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch.bridge import (from_jax_mvs_params,
                                       load_mvs_checkpoint,
                                       to_jax_mvs_params)
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs import fmt as TF
from s_volsdf_tpu_torch.models.mvs import transmvsnet as T
from s_volsdf_tpu_torch.models.mvs.warp import _proj_grid, homo_warping
from test_torch_config import lively_mvs_tree
from test_torch_runner import (RES, assert_stage_matches, engines,
                               f32_of_bf16_operands, first_sample,
                               lively_checkpoint, stage_pair, sure_pixels)

H = W = 64
NDEPTHS = (16, 8, 8)
TOL = 1e-5
# The JAX functions jitted: eagerly, the backbone's DCN scans take ten
# times longer than their compilation.
j_feature_net = jax.jit(J.trans_feature_net)
j_fmt_with_pathway = jax.jit(JF.fmt_with_pathway)
j_depth_net = jax.jit(J.trans_depth_net)
j_stage = jax.jit(J.transmvsnet_stage, static_argnums=(1, 7),
                  static_argnames=("ndepths",))


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    p = jax.tree.map(np.asarray, J.init_transmvsnet(jax.random.PRNGKey(0),
                                                    ndepths=NDEPTHS))
    p = lively_mvs_tree(p, np.random.default_rng(0))
    jp = jax.tree.map(jnp.asarray, p)
    return p, jp, from_jax_mvs_params(p, NDEPTHS, model="transmvsnet")


@pytest.fixture(scope="module")
def inputs():
    scene = make_sphere_scene(n_views=3, img_res=(H, W))
    proj = {}
    for s, scale in enumerate(T.STAGE_SCALES):
        mats = []
        for v in range(3):
            K = scene.intrinsics[v].copy()
            K[:2] /= scale
            mats.append(np.stack([np.linalg.inv(scene.poses[v]), K]))
        proj[f"stage{s + 1}"] = np.stack(mats).astype(np.float32)
    depth_range = np.linspace(1.0, 4.0, 192).astype(np.float32)
    return scene.images.astype(np.float32), proj, depth_range


@pytest.fixture(scope="module")
def backbones(nets, inputs):
    """Both packages' backbone pyramids of the three views, (H, W, C)
    and (C, H, W)."""
    _, jp, net = nets
    imgs, _, _ = inputs
    jb = [j_feature_net(jp["feature"], jnp.asarray(imgs[v]))
          for v in range(3)]
    tb = T.trans_feature_net(net.feature,
                             torch.tensor(imgs).permute(0, 3, 1, 2))
    return jb, tb


@pytest.fixture(scope="module")
def pathways(nets, inputs, backbones):
    """Both packages' features: the backbones, then the FMT pathway with
    view 0 as the reference (the port's `transmvsnet_features`)."""
    _, jp, net = nets
    imgs, _, _ = inputs
    jb, _ = backbones
    return (j_fmt_with_pathway(jp["fmt"], jb),
            T.transmvsnet_features(net,
                                   torch.tensor(imgs).permute(0, 3, 1, 2)))


def _close(got, want, rel=TOL):
    """Within rel of the reference's largest magnitude."""
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


def _hwc(t):
    return t.permute(1, 2, 0).numpy()


def _chw(a):
    return torch.tensor(np.asarray(a)).permute(2, 0, 1).contiguous()


def test_bridge_round_trip_exact(nets):
    p, _, net = nets
    q = to_jax_mvs_params(net)
    assert jax.tree.structure(q) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(q)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_converted_checkpoint_loads_exact(nets, tmp_path):
    """The JAX package's checkpoint (leaves in JAX's flatten order of
    `init_transmvsnet`; the DCN weight (9 Cin, Cout) tap-major) loads
    leaf for leaf."""
    p, _, _ = nets
    jckpt.save_state(str(tmp_path / "ck"), p, model="transmvsnet")
    net = T.init_transmvsnet(torch.Generator().manual_seed(1), NDEPTHS)
    load_mvs_checkpoint(net, str(tmp_path / "ck"))
    assert tuple(net.feature.out1.dcn1.w.shape) == (9 * 32, 32)
    for a, b in zip(jax.tree.leaves(p),
                    jax.tree.leaves(to_jax_mvs_params(net))):
        np.testing.assert_array_equal(a, b)


def test_dcn_block_matches_jax(nets):
    """The DCN (offset-and-mask conv, cat(o1, o2) read as per-tap (dy,
    dx), sigmoid mask, deformable conv) on unit-scale input: offsets of
    a few pixels with samples past the edges, masks spread over (0, 1)."""
    _, jp, net = nets
    x = np.random.default_rng(3).normal(size=(16, 20, 32)).astype(np.float32)
    want = J.dcn_apply(jp["feature"]["out3"]["dcn1"], jnp.asarray(x))
    dcn = net.feature.out3.dcn1
    got = dcn(_chw(x)[None])[0]
    np.testing.assert_allclose(_hwc(got), np.asarray(want), atol=TOL)
    om = dcn.offset_conv(_chw(x)[None])[0]
    ys = torch.arange(16.0)[None, :, None] + om[0:18:2]
    assert om[:18].abs().max() > 2 and (ys < 0).any() and (ys > 15).any()
    assert torch.sigmoid(om[18:]).std() > 0.1


def test_dcn_is_live(nets):
    """Zeroing the offset conv changes the DCN; it is then half the plain
    3x3 conv (every mask sigmoid(0)) plus the bias."""
    _, _, net = nets
    dcn = net.feature.out3.dcn1
    x = _chw(np.random.default_rng(4).normal(size=(16, 20, 32))
             .astype(np.float32))[None]
    live = dcn(x)
    w = dcn.offset_conv.weight.data.clone()
    b = dcn.offset_conv.bias.data.clone()
    try:
        dcn.offset_conv.weight.data.zero_()
        dcn.offset_conv.bias.data.zero_()
        still = dcn(x)
    finally:
        dcn.offset_conv.weight.data, dcn.offset_conv.bias.data = w, b
    assert (live - still).abs().max() > 0.1 * still.abs().max()
    kernel = dcn.w.reshape(3, 3, 32, 32).permute(3, 2, 0, 1)
    conv = 0.5 * F.conv2d(x, kernel, padding=1) + dcn.b[:, None, None]
    np.testing.assert_allclose(still.numpy(), conv.numpy(), atol=TOL)


def test_homo_warping_behind_camera_matches_jax():
    """TransMVSNet's warp (align_corners=True; grid points of hypotheses
    behind the source camera set to -99) with such points present."""
    rng = np.random.default_rng(5)
    src = rng.normal(size=(12, 16, 8)).astype(np.float32)
    K = np.array([[14.0, 0, 8], [0, 14.0, 6], [0, 0, 1]], np.float32)
    ref = np.eye(4, dtype=np.float32)
    ref[:3, :3] = K
    src_proj = np.eye(4, dtype=np.float32)
    src_proj[:3, 3] = [0.3, -0.2, -2.0]       # 2 units in front of the ref
    src_proj[:3, :4] = K @ src_proj[:3, :4]
    depths = np.linspace(0.5, 4.0, 8).astype(np.float32)
    _, valid = _proj_grid(torch.tensor(src_proj), torch.tensor(ref),
                          torch.tensor(depths), 12, 16)
    assert valid.any() and not valid.all()
    want = jhomo_warping(jnp.asarray(src), jnp.asarray(src_proj),
                         jnp.asarray(ref), jnp.asarray(depths),
                         align_corners=True, mask_behind=True)
    got = homo_warping(_chw(src), torch.tensor(src_proj), torch.tensor(ref),
                       torch.tensor(depths), align_corners=True,
                       mask_behind=True)
    np.testing.assert_allclose(got.permute(1, 2, 3, 0).numpy(),
                               np.asarray(want), atol=TOL)
    assert np.abs(got.numpy()[:, ~valid.numpy()]).max() == 0.0


def test_trans_feature_net_matches_jax(backbones):
    jb, tb = backbones
    for v in range(3):
        for k in ("stage1", "stage2", "stage3"):
            _close(_hwc(tb[v][k]), np.asarray(jb[v][k]))


def test_sine_position_encoding_matches_jax():
    feat = np.random.default_rng(6).normal(size=(9, 13, 32)).astype(np.float32)
    want = JF.sine_position_encoding(jnp.asarray(feat))
    got = TF.sine_position_encoding(torch.tensor(feat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_linear_attention_matches_jax():
    rng = np.random.default_rng(7)
    q = rng.normal(size=(50, 8, 4)).astype(np.float32)
    k = rng.normal(size=(70, 8, 4)).astype(np.float32)
    v = rng.normal(size=(70, 8, 4)).astype(np.float32)
    want = JF.linear_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    got = TF.linear_attention(torch.tensor(q), torch.tensor(k),
                              torch.tensor(v))
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("layer", [0, 1])
def test_encoder_layer_matches_jax(nets, layer):
    """A self layer (source = x) and a cross layer (another source)."""
    _, jp, net = nets
    rng = np.random.default_rng(8)
    x = rng.normal(size=(60, 32)).astype(np.float32)
    src = x if layer == 0 else rng.normal(size=(40, 32)).astype(np.float32)
    want = JF.encoder_layer(jp["fmt"]["fmt"]["layers"][layer],
                            jnp.asarray(x), jnp.asarray(src))
    got = net.fmt.fmt.layers[layer](torch.tensor(x), torch.tensor(src))
    _close(got.numpy(), np.asarray(want))


def test_fmt_with_pathway_matches_jax(pathways):
    want, got = pathways
    for v in range(3):
        for k in ("stage1", "stage2", "stage3"):
            _close(_hwc(got[v][k]), np.asarray(want[v][k]))


def test_pixelwise_net_matches_jax(nets):
    _, jp, net = nets
    sim = np.random.default_rng(9).normal(size=(8, 12, 16)).astype(np.float32)
    want = J.pixelwise_net(jp["pixelwise"], jnp.asarray(sim))
    got = T.pixelwise_net(net.pixelwise, torch.tensor(sim))
    assert np.ptp(np.asarray(want)) > 1e-3
    _close(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("given", [False, True])
def test_trans_depth_net_matches_jax(nets, inputs, given):
    """Stage 2's depth net on random features: its own view weights, or
    given ones (as the later stages get them)."""
    _, jp, net = nets
    _, proj, _ = inputs
    rng = np.random.default_rng(10)
    feats = [rng.normal(size=(32, 32, 16)).astype(np.float32)
             for _ in range(3)]
    dv = np.broadcast_to(np.linspace(2.0, 3.0, 8, dtype=np.float32)
                         [:, None, None], (8, 32, 32)).copy()
    vw = rng.uniform(0.2, 1.0, (2, 32, 32)).astype(np.float32) if given \
        else None
    want, jvw = j_depth_net(
        jp["cost_reg"][1], jp["pixelwise"], [jnp.asarray(f) for f in feats],
        jnp.asarray(proj["stage2"]), jnp.asarray(dv),
        None if vw is None else jnp.asarray(vw))
    got, tvw = T.trans_depth_net(
        net.cost_regularization[1], net.pixelwise,
        [_chw(f) for f in feats], torch.tensor(proj["stage2"]),
        torch.tensor(dv), None if vw is None else torch.tensor(vw))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert_stage_matches(got, want, "transmvsnet")
    if given:
        np.testing.assert_array_equal(tvw.numpy(), vw)
    else:
        _close(tvw.numpy(), np.asarray(jvw))


def test_cascade_matches_jax(nets, inputs, pathways):
    """All three stages chained on the FMT's features, each side on its
    own previous depth and view weights (the runner's `extra`, upsampled
    2x a stage)."""
    _, jp, net = nets
    _, proj, depth_range = inputs
    jfeats, tfeats = pathways
    jprev = jvw = tprev = tvw = None
    for s in range(3):
        want, jvw = j_stage(
            jp, s, jfeats, jnp.asarray(proj[f"stage{s + 1}"]),
            jnp.asarray(depth_range), jprev, jvw, (H, W), ndepths=NDEPTHS)
        got, tvw = T.transmvsnet_stage(
            net, s, tfeats, torch.tensor(proj[f"stage{s + 1}"]),
            torch.tensor(depth_range), tprev, tvw, (H, W), ndepths=NDEPTHS)
        want = {k: np.asarray(v) for k, v in want.items()}
        gotn = {k: v.numpy() for k, v in got.items()}
        assert np.ptp(want["prob_volume"]) > 1e-2, s
        assert_stage_matches(gotn, want, "transmvsnet")
        assert tvw.shape == (2, H // T.STAGE_SCALES[s],
                             W // T.STAGE_SCALES[s])
        _close(tvw.numpy(), np.asarray(jvw))
        jprev, tprev = jnp.asarray(want["depth"]), got["depth"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("transmvsnet") / "data")
    make_dtu_fixture(root, scan_id=106, img_res=RES)
    return root


def test_stage_bf16_matches_jax(fixture_root, tmp_path, monkeypatch):
    """Stage 0 of MVSEngine at mvs.compute_dtype="bfloat16" against the
    JAX engine's, which casts every leaf of ndim >= 4
    (`cast_conv_weights`): the convs, the DCNs' offset convs and
    PixelwiseNet's 1x1x1 kernels bf16; the DCNs' (9 Cin, Cout) kernels
    and the FMT's linears float32. The FMT pathway's convs round their
    input to bf16, where a float32 difference of about 1e-6 relative
    between the packages moves some values across a rounding boundary
    (a bf16 unit, 2^-8, there; stage 2 and 3 features 0.1-0.5% apart
    measured even with the port's output rounding taken away). So the
    bars are bf16's: prob and confidence within 1e-3 (measured 2.1e-4,
    1.8e-4), the winner-take-all hypothesis equal where the top two
    differ by more than 1e-3 (13% of the pixels here); with the output
    rounding taken away (`f32_of_bf16_operands`), prob within 2e-4
    (measured 5.9e-5)."""
    ck = lively_checkpoint(fixture_root, "transmvsnet", str(tmp_path / "ck"))
    jeng, teng = engines(fixture_root, "transmvsnet", ck, "bfloat16")
    dt = {type(m).__name__: m for m in teng.net.modules()}
    assert dt["DCN"].offset_conv.weight.dtype == torch.bfloat16
    assert dt["DCN"].w.dtype == torch.float32
    assert dt["Dense"].w.dtype == torch.float32
    assert teng.net.pixelwise.conv0.conv.weight.dtype == torch.bfloat16
    assert all(m.weight.dtype == torch.bfloat16
               for m in teng.net.modules() if isinstance(m, B.CONVS))
    s = first_sample(fixture_root)
    want, _, got, _ = stage_pair(jeng, teng, s, 0)
    assert np.ptp(want["prob_volume"]) > 1e-2
    assert np.abs(got["prob_volume"] - want["prob_volume"]).max() <= 1e-3
    assert np.abs(got["photometric_confidence"]
                  - want["photometric_confidence"]).max() <= 1e-3
    sure = sure_pixels(want["prob_volume"], 1e-3)
    assert sure.mean() >= 0.05
    np.testing.assert_array_equal(got["prob_volume"].argmax(0)[sure],
                                  want["prob_volume"].argmax(0)[sure])
    f32_of_bf16_operands(monkeypatch)
    _, _, got, _ = stage_pair(jeng, teng, s, 0)
    assert np.abs(got["prob_volume"] - want["prob_volume"]).max() <= 2e-4
