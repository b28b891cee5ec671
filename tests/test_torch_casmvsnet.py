"""The port's CasMVSNet against the JAX package's
(s_volsdf_tpu/models/mvs/casmvsnet.py), with the weights of
`init_casmvsnet(PRNGKey(0))` (BN statistics randomised) bridged into
the port, at the shapes of tests/test_mvs_models.py: three 64x64 views,
ndepths (16, 8, 8).

Tolerances: features and cost-regularization logits atol 1e-5;
prob_volume atol 1e-5; depth rtol 1e-5; photometric confidence atol
1e-5 where both sides truncate the expected hypothesis index to the
same integer, with at most 0.1% of pixels disagreeing on that index (a
1e-7 difference can move a pixel across an integer, which changes its
confidence by a whole window). The bridge's round trip and the
converted-checkpoint load are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.data.synthetic import make_sphere_scene
from s_volsdf_tpu.models.mvs import casmvsnet as J
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch.bridge import (from_jax_mvs_params,
                                       load_mvs_checkpoint,
                                       to_jax_mvs_params)
from s_volsdf_tpu_torch.models.mvs import casmvsnet as T

H = W = 64
NDEPTHS = (16, 8, 8)
ATOL = 1e-5


def _randomise_bn(tree, rng):
    """Random BN statistics, so the bridge's BN mapping is exercised."""
    if isinstance(tree, list):
        return [_randomise_bn(t, rng) for t in tree]
    if "scale" in tree:
        c = tree["scale"].shape[0]
        return {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                "bias": rng.normal(0, 0.1, c).astype(np.float32),
                "mean": rng.normal(0, 0.1, c).astype(np.float32),
                "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    return {k: (_randomise_bn(v, rng) if isinstance(v, (dict, list)) else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def nets():
    p = jax.tree.map(np.asarray, J.init_casmvsnet(jax.random.PRNGKey(0),
                                                  ndepths=NDEPTHS))
    p = _randomise_bn(p, np.random.default_rng(0))
    jp = jax.tree.map(jnp.asarray, p)
    return p, jp, from_jax_mvs_params(p, ndepths=NDEPTHS)


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


def test_bridge_round_trip_exact(nets):
    p, _, net = nets
    q = to_jax_mvs_params(net)
    assert jax.tree.structure(q) == jax.tree.structure(p)
    for a, b in zip(jax.tree.leaves(p), jax.tree.leaves(q)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_converted_checkpoint_loads_exact(nets, tmp_path):
    """The JAX package's checkpoint format (what tools/convert_ckpt.py
    writes) loads into the port leaf for leaf."""
    p, _, _ = nets
    jckpt.save_state(str(tmp_path / "ck"), p, model="casmvsnet")
    net = T.init_casmvsnet(torch.Generator().manual_seed(1), NDEPTHS)
    load_mvs_checkpoint(net, str(tmp_path / "ck"))
    for a, b in zip(jax.tree.leaves(p),
                    jax.tree.leaves(to_jax_mvs_params(net))):
        np.testing.assert_array_equal(a, b)


def test_feature_net_matches_jax(nets, inputs):
    _, jp, net = nets
    imgs, _, _ = inputs
    want = J.feature_net(jp["feature"], jnp.asarray(imgs))
    got = net.feature(torch.tensor(imgs).permute(0, 3, 1, 2))
    for k in ("stage1", "stage2", "stage3"):
        np.testing.assert_allclose(got[k].permute(0, 2, 3, 1).numpy(),
                                   np.asarray(want[k]), atol=ATOL,
                                   err_msg=k)


def test_cost_reg_net_matches_jax(nets):
    _, jp, net = nets
    x = np.random.default_rng(1).uniform(size=(1, 16, 16, 16, 32))
    x = x.astype(np.float32)
    want = J.cost_reg_net(jp["cost_reg"][0], jnp.asarray(x))
    got = net.cost_regularization[0](torch.tensor(x).permute(0, 4, 1, 2, 3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def _index(prob):
    D = prob.shape[0]
    return np.sum(prob * np.arange(D, dtype=np.float32)[:, None, None],
                  axis=0).astype(np.int32)


def test_cascade_matches_jax(nets, inputs):
    """All three stages chained, each side on its own previous depth."""
    _, jp, net = nets
    imgs, proj, depth_range = inputs
    jfeats = J.casmvsnet_features(jp, jnp.asarray(imgs))
    tfeats = T.casmvsnet_features(net,
                                  torch.tensor(imgs).permute(0, 3, 1, 2))
    jprev = tprev = None
    for s in range(3):
        want = J.casmvsnet_stage(jp, s, jfeats,
                                 jnp.asarray(proj[f"stage{s + 1}"]),
                                 jnp.asarray(depth_range), jprev, (H, W),
                                 ndepths=NDEPTHS)
        got = T.casmvsnet_stage(net, s, tfeats,
                                torch.tensor(proj[f"stage{s + 1}"]),
                                torch.tensor(depth_range), tprev, (H, W),
                                ndepths=NDEPTHS)
        want = {k: np.asarray(v) for k, v in want.items()}
        gotn = {k: v.numpy() for k, v in got.items()}
        np.testing.assert_allclose(gotn["depth_values"],
                                   want["depth_values"], rtol=1e-6)
        np.testing.assert_allclose(gotn["prob_volume"], want["prob_volume"],
                                   atol=ATOL, err_msg=f"stage {s}")
        np.testing.assert_allclose(gotn["depth"], want["depth"], rtol=1e-5,
                                   err_msg=f"stage {s}")
        same = _index(gotn["prob_volume"]) == _index(want["prob_volume"])
        assert np.mean(~same) <= 1e-3, f"stage {s}: {np.mean(~same)}"
        np.testing.assert_allclose(
            gotn["photometric_confidence"][same],
            want["photometric_confidence"][same], atol=ATOL)
        jprev, tprev = jnp.asarray(want["depth"]), got["depth"]
