"""The port's UCSNet (s_volsdf_tpu_torch/models/mvs/ucsnet.py) against
the JAX package's (s_volsdf_tpu/models/mvs/ucsnet.py), with the weights
of `init_ucsnet(PRNGKey(0))` made lively (`lively_mvs_tree`: random BN,
He's gain) bridged into the port, at the shapes of
tests/test_torch_casmvsnet.py: three 64x64 views, ndepths (16, 8, 8).

Bars: features, the 2-D transposed-conv block and the hypotheses within
1e-5 relative to their scale (float32 sums in another order); the MVS
volumes 1e-5 (README "Verified parity"): prob_volume 1e-5 absolute,
regressed depth and the lamb-scaled variance 1e-5 relative;
photometric confidence 1e-5 where both sides truncate the expected
hypothesis index to the same integer (at most 0.1% of pixels may not).
One stage at the JAX defaults (bf16 convs) against the JAX engine with
`cast_conv_weights`: see `test_stage_bf16_matches_jax` (the port's bf16
convs round their output to bf16, JAX's do not). The bridge's round trip
and the converted-checkpoint load are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.models.mvs import blocks as JB
from s_volsdf_tpu.models.mvs import hypotheses as JH
from s_volsdf_tpu.models.mvs import ucsnet as J
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch.bridge import (from_jax_mvs_params,
                                       load_mvs_checkpoint,
                                       to_jax_mvs_params)
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs import hypotheses as TH
from s_volsdf_tpu_torch.models.mvs import ucsnet as T
from test_torch_casmvsnet import _index
from test_torch_config import lively_mvs_tree
from test_torch_runner import (RES, engines, f32_of_bf16_operands,
                               first_sample, lively_checkpoint, stage_pair)

H = W = 64
NDEPTHS = (16, 8, 8)
TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def nets():
    p = jax.tree.map(np.asarray, J.init_ucsnet(jax.random.PRNGKey(0),
                                               stage_configs=NDEPTHS))
    p = lively_mvs_tree(p, np.random.default_rng(0))
    jp = jax.tree.map(jnp.asarray, p)
    return p, jp, from_jax_mvs_params(p, NDEPTHS, model="ucsnet")


@pytest.fixture(scope="module")
def inputs():
    from s_volsdf_tpu.data.synthetic import make_sphere_scene
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


def _close(got, want, rel=TOL):
    """Within rel of the reference's largest magnitude."""
    np.testing.assert_allclose(got, want, atol=rel * np.abs(want).max())


def test_bridge_round_trip_exact(nets):
    p, _, net = nets
    q = to_jax_mvs_params(net)
    assert jax.tree.structure(q) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(q)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_converted_checkpoint_loads_exact(nets, tmp_path):
    """The JAX package's checkpoint (what tools/convert_ckpt.py writes,
    leaves in JAX's flatten order of `init_ucsnet`) loads leaf for leaf."""
    p, _, _ = nets
    jckpt.save_state(str(tmp_path / "ck"), p, model="ucsnet")
    net = T.init_ucsnet(torch.Generator().manual_seed(1), NDEPTHS)
    load_mvs_checkpoint(net, str(tmp_path / "ck"))
    for a, b in zip(jax.tree.leaves(p),
                    jax.tree.leaves(to_jax_mvs_params(net))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(8, 12), (5, 7)])
def test_deconv2d_block_matches_jax(nets, hw):
    """The stride-2 transposed conv block (JAX: an input-dilated conv on
    flipped kernels) on the bridged weights."""
    _, jp, net = nets
    x = np.random.default_rng(1).normal(size=(2, *hw, 32)).astype(np.float32)
    want = JB.deconv2d(jp["feature"]["deconv1"]["deconv"], jnp.asarray(x))
    got = net.feature.deconv1.deconv(torch.tensor(x).permute(0, 3, 1, 2))
    assert got.shape[-2:] == (2 * hw[0], 2 * hw[1])
    _close(got.permute(0, 2, 3, 1).numpy(), np.asarray(want))


def test_feat_ext_net_matches_jax(nets, inputs):
    _, jp, net = nets
    imgs, _, _ = inputs
    want = J.feat_ext_net(jp["feature"], jnp.asarray(imgs))
    got = net.feature(torch.tensor(imgs).permute(0, 3, 1, 2))
    for k in ("stage1", "stage2", "stage3"):
        _close(got[k].permute(0, 2, 3, 1).numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("case", ["range", "inverse", "per_pixel"])
def test_uncertainty_aware_samples_matches_jax(case):
    """The first stage's span (linear or in 1/d) and the per-pixel
    window [d - min(d, sigma), d + sigma], with pixels where sigma > d
    (the window's lower clamp)."""
    rng = np.random.default_rng(2)
    if case == "per_pixel":
        cur = rng.uniform(1.0, 4.0, (12, 16)).astype(np.float32)
        var = rng.uniform(0.1, 5.0, (12, 16)).astype(np.float32)
        assert (var > cur).any() and (var < cur).any()
    else:
        cur, var = np.linspace(1.0, 4.0, 48).astype(np.float32), None
    inv = case == "inverse"
    want = JH.uncertainty_aware_samples(
        jnp.asarray(cur), None if var is None else jnp.asarray(var), 8,
        (12, 16), inverse_depth=inv)
    got = TH.uncertainty_aware_samples(
        torch.tensor(cur), None if var is None else torch.tensor(var), 8,
        (12, 16), inverse_depth=inv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_cascade_matches_jax(nets, inputs):
    """All three stages chained, each side on its own previous depth and
    variance (the runner's `extra`)."""
    _, jp, net = nets
    imgs, proj, depth_range = inputs
    jfeats = J.ucsnet_features(jp, jnp.asarray(imgs))
    tfeats = T.ucsnet_features(net, torch.tensor(imgs).permute(0, 3, 1, 2))
    jprev = jvar = tprev = tvar = None
    for s in range(3):
        want = J.ucsnet_stage(jp, s, jfeats,
                              jnp.asarray(proj[f"stage{s + 1}"]),
                              jnp.asarray(depth_range), jprev, jvar, (H, W),
                              stage_configs=NDEPTHS)
        got = T.ucsnet_stage(net, s, tfeats,
                             torch.tensor(proj[f"stage{s + 1}"]),
                             torch.tensor(depth_range), tprev, tvar, (H, W),
                             stage_configs=NDEPTHS)
        want = {k: np.asarray(v) for k, v in want.items()}
        gotn = {k: v.numpy() for k, v in got.items()}
        assert np.ptp(want["prob_volume"]) > 1e-2, s    # not uniform
        np.testing.assert_allclose(gotn["depth_values"],
                                   want["depth_values"], rtol=TOL)
        np.testing.assert_allclose(gotn["prob_volume"], want["prob_volume"],
                                   atol=TOL, err_msg=f"stage {s}")
        np.testing.assert_allclose(gotn["depth"], want["depth"], rtol=TOL,
                                   err_msg=f"stage {s}")
        np.testing.assert_allclose(gotn["variance"], want["variance"],
                                   rtol=TOL, err_msg=f"stage {s}")
        same = _index(gotn["prob_volume"]) == _index(want["prob_volume"])
        assert np.mean(~same) <= 1e-3, f"stage {s}: {np.mean(~same)}"
        np.testing.assert_allclose(gotn["photometric_confidence"][same],
                                   want["photometric_confidence"][same],
                                   atol=TOL)
        jprev, jvar = jnp.asarray(want["depth"]), jnp.asarray(want["variance"])
        tprev, tvar = got["depth"], got["variance"]


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ucsnet") / "data")
    make_dtu_fixture(root, scan_id=106, img_res=RES)
    return root


def test_stage_bf16_matches_jax(fixture_root, tmp_path, monkeypatch):
    """Stage 0 of MVSEngine at mvs.compute_dtype="bfloat16" (the JAX
    default) against the JAX engine's, which casts every kernel of ndim
    >= 4 (`cast_conv_weights`): the port's cast reaches every conv, the
    transposed 2-D ones included. With the output rounding of the port's
    bf16 convs taken away (`f32_of_bf16_operands`) the stage is JAX's
    within 1e-6 (measured 1.5e-8 prob, 2.1e-7 depth); as it runs, that
    rounding (2^-9 relative a conv) leaves prob within 2e-4 and depth
    within 5e-5 relative (measured 9.1e-5, 7.4e-6)."""
    ck = lively_checkpoint(fixture_root, "ucsnet", str(tmp_path / "ck"))
    jeng, teng = engines(fixture_root, "ucsnet", ck, "bfloat16")
    convs = [m for m in teng.net.modules() if isinstance(m, B.CONVS)]
    assert any(isinstance(m, B.ConvTranspose2d) for m in convs)
    assert all(m.weight.dtype == torch.bfloat16 for m in convs)
    s = first_sample(fixture_root)
    want, jvar, got, tvar = stage_pair(jeng, teng, s, 0)
    assert np.ptp(want["prob_volume"]) > 1e-2
    assert np.abs(got["prob_volume"] - want["prob_volume"]).max() <= 2e-4
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=5e-5)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-3)
    f32_of_bf16_operands(monkeypatch)
    _, _, got, tvar = stage_pair(jeng, teng, s, 0)
    assert np.abs(got["prob_volume"] - want["prob_volume"]).max() <= 1e-6
    np.testing.assert_allclose(got["depth"], want["depth"], rtol=1e-6)
    np.testing.assert_allclose(tvar, jvar, rtol=1e-5)
