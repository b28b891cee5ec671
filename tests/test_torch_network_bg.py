"""The port's NeRF++ background model (models/network_bg.py) against the
JAX package's, piece by piece and as a whole render at eval, on the
small bmvs config of test_torch_config.shrink_bmvs with the same weights
(bridged from the JAX init).

Tolerances and the measured errors:
  * depth2pts_outside on rays from inside the sphere: 1e-5 absolute
    (measured: points 4.8e-7, real depths 1.9e-6); a ray through the
    origin gives NaN points in both packages (0/0 in the Rodrigues axis).
  * the two compositors: 1e-6 (measured 6e-8).
  * bg_mlp_raw and bg_rgb_mlp: 1e-5 (measured 1.2e-7, 6e-8).
  * render_rays_bg at eval (training=False, fast=-1: no random draw),
    with and without near_pose: rgb_values, depth_values, normal_map and
    acc within 2e-4, the VolSDF render bar (measured: depth 5.5e-6, rgb
    4.7e-6, normal 4.0e-7, acc 3.0e-7); depth_values_all within 2e-4
    relative (measured 3.5e-5): it reaches 5e5, since the last
    background sample lies at inverse depth 0, 1e6 away, so a weight
    1.4e-6 apart (measured) moves it by a whole unit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.models import network_bg as jbg
from s_volsdf_tpu_torch.models import network_bg as tbg
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import (N_RAYS, bg_params_pair, scene_and_volumes,
                               small_bmvs_configs)

R_SPHERE = 3.0


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inside_rays(seed, n=64):
    """Rays from points inside the sphere (|o| < 2.5), unit directions,
    and inverse depths in [0, 1/r], as float32 numpy (n, 8, ...)."""
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3))
    o *= rng.uniform(0.2, 2.5, (n, 1)) / np.linalg.norm(o, axis=-1,
                                                        keepdims=True)
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    depth = rng.uniform(0.0, 1.0 / R_SPHERE, (n, 8))
    o = np.broadcast_to(o[:, None], (n, 8, 3))
    d = np.broadcast_to(d[:, None], (n, 8, 3))
    return [np.ascontiguousarray(a, dtype=np.float32) for a in (o, d, depth)]


def test_depth2pts_outside_matches_jax():
    o, d, depth = _inside_rays(0)
    jp, jr = jbg.depth2pts_outside(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(depth), R_SPHERE)
    tp, tr = tbg.depth2pts_outside(torch.tensor(o), torch.tensor(d),
                                   torch.tensor(depth), R_SPHERE)
    assert tp.shape == (64, 8, 4)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-5)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-5,
                               rtol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(tp.numpy()[..., :3], axis=-1),
                               1.0, atol=1e-5)


def test_depth2pts_outside_ray_through_origin_is_nan_in_both():
    """A ray through the origin has no Rodrigues axis (o x p_sphere = 0):
    both packages give NaN points there, and finite real depths."""
    o = np.array([[[0.0, 0.0, -1.0]] * 3], np.float32)
    d = np.array([[[0.0, 0.0, 1.0]] * 3], np.float32)
    depth = np.array([[0.05, 0.15, 0.25]], np.float32)
    jp, jr = jbg.depth2pts_outside(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(depth), R_SPHERE)
    tp, tr = tbg.depth2pts_outside(torch.tensor(o), torch.tensor(d),
                                   torch.tensor(depth), R_SPHERE)
    assert np.isnan(np.asarray(jp)[..., :3]).all()
    assert torch.isnan(tp[..., :3]).all()
    np.testing.assert_array_equal(tp[..., 3].numpy(), depth)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=1e-6)


def test_compositors_match_jax():
    rng = np.random.default_rng(1)
    z = np.sort(rng.uniform(0.1, 3.0, (N_RAYS, 12)), axis=-1).astype(np.float32)
    z_max = (z[:, -1] + rng.uniform(0, 0.5, N_RAYS)).astype(np.float32)
    dens = rng.uniform(0, 20, (N_RAYS, 12)).astype(np.float32)
    jw, jt = jbg._fg_volume_rendering(jnp.asarray(z), jnp.asarray(z_max),
                                      jnp.asarray(dens))
    tw, tt = tbg._fg_volume_rendering(torch.tensor(z), torch.tensor(z_max),
                                      torch.tensor(dens))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), atol=1e-6)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6)
    zb = np.sort(rng.uniform(0, 1 / R_SPHERE, (N_RAYS, 8)),
                 axis=-1)[:, ::-1].copy().astype(np.float32)
    bd = rng.uniform(0, 5, (N_RAYS, 8)).astype(np.float32)
    jbw = jbg._bg_volume_rendering(jnp.asarray(zb), jnp.asarray(bd))
    tbw = tbg._bg_volume_rendering(torch.tensor(zb), torch.tensor(bd))
    np.testing.assert_allclose(tbw.numpy(), np.asarray(jbw), atol=1e-6)


def test_bg_mlps_match_jax():
    jcfg, tcfg = small_bmvs_configs()
    jp, tp = bg_params_pair(jcfg, seed=2)
    rng = np.random.default_rng(2)
    pts = np.concatenate([rng.normal(size=(200, 3)),
                          rng.uniform(0, 1 / R_SPHERE, (200, 1))],
                         -1).astype(np.float32)
    jout = jbg.bg_mlp_raw(jp["bg_sdf"], jcfg.model, jnp.asarray(pts))
    tout = tbg.bg_mlp_raw(tp.bg_sdf, tcfg.model, torch.tensor(pts))
    assert tout.shape == (200, 1 + 48)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               atol=1e-5)
    dirs = rng.normal(size=(200, 3)).astype(np.float32)
    feats = np.asarray(jout)[:, 1:]
    jrgb = jbg.bg_rgb_mlp(jp["bg_rgb"], jcfg.model, jnp.asarray(dirs),
                          jnp.asarray(feats))
    trgb = tbg.bg_rgb_mlp(tp.bg_rgb, tcfg.model, torch.tensor(dirs),
                          torch.tensor(feats))
    np.testing.assert_allclose(trgb.detach().numpy(), np.asarray(jrgb),
                               atol=1e-5)


def test_bg_mlps_are_float32_under_the_bf16_knobs():
    """As in the JAX package, the background MLPs' products are float32
    whatever model.compute_dtype says; the foreground's are not."""
    _, tcfg = small_bmvs_configs()
    jcfg, _ = small_bmvs_configs()
    _, tp = bg_params_pair(jcfg, seed=2)
    bf16 = tcfg.model.__class__(**{**tcfg.model.__dict__,
                                   "compute_dtype": "bfloat16",
                                   "activation_dtype": "bfloat16"})
    pts = torch.tensor(np.random.default_rng(3).normal(
        size=(50, 4)).astype(np.float32))
    assert torch.equal(tbg.bg_mlp_raw(tp.bg_sdf, bf16, pts),
                       tbg.bg_mlp_raw(tp.bg_sdf, tcfg.model, pts))


def _eval_inputs(near):
    """uv (1, N, 2) of view 0 of the small sphere scene, its pose and
    intrinsics (1, 4, 4), and view 1's pose as the near pose."""
    scene, _, _ = scene_and_volumes()
    H, W = scene.img_res
    rng = np.random.default_rng(5)
    pix = rng.integers(0, H * W, N_RAYS)
    uv = np.stack([pix % W, pix // W], -1).astype(np.float32)[None]
    return (uv, scene.poses[:1], scene.intrinsics[:1],
            scene.poses[1:2] if near else None)


@pytest.mark.parametrize("near", [False, True])
def test_render_rays_bg_eval_matches_jax(near):
    jcfg, tcfg = small_bmvs_configs()
    jp, tp = bg_params_pair(jcfg, seed=4)
    uv, pose, intr, near_pose = _eval_inputs(near)
    want = jbg.render_rays_bg(
        jp, jcfg.model, jnp.asarray(uv), jnp.asarray(pose),
        jnp.asarray(intr), jax.random.PRNGKey(0), training=False, fast=-1,
        near_pose=None if near_pose is None else jnp.asarray(near_pose))
    sweeps = fused_sdf.plain_sweeps
    with torch.no_grad():
        got = tbg.render_rays_bg(
            tp, tcfg.model, torch.tensor(uv), torch.tensor(pose),
            torch.tensor(intr), None, training=False, fast=-1,
            near_pose=None if near_pose is None else torch.tensor(near_pose))
    assert fused_sdf.plain_sweeps > sweeps     # the CPU's plain route
    for name in ("rgb_values", "depth_values", "depth_values_all",
                 "normal_map", "acc"):
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == w.shape and np.isfinite(g).all(), name
        if name == "depth_values_all":
            np.testing.assert_allclose(g, w, rtol=2e-4, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, atol=2e-4, err_msg=name)
    S = (tcfg.model.sampler.N_samples + tcfg.model.sampler.N_samples_extra
         + 1)
    assert got.weights.shape == (N_RAYS, S)
    # The background is live: some of the colour comes from past the
    # sphere, and the near pose changes the colour, not the depth.
    assert (got.acc - got.weights.sum(-1)).abs().max() > 1e-3
    if near:
        with torch.no_grad():
            plain = tbg.render_rays_bg(
                tp, tcfg.model, torch.tensor(uv), torch.tensor(pose),
                torch.tensor(intr), None, training=False, fast=-1)
        assert (plain.rgb_values - got.rgb_values).abs().max() > 1e-4
        torch.testing.assert_close(plain.depth_values, got.depth_values,
                                   rtol=0, atol=0)

