"""The port's render_rays against the JAX package's, in training at
fast=1 with the same jitter feed (tools/paired_jitter.py).

Tolerance 2e-4 absolute, the VolSDF render bar the JAX package met
against the original torch code (README "Verified parity"): float32
MLP sums in another order, through double backprop for grad_theta.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from s_volsdf_tpu.models.network import render_rays as jrender
from s_volsdf_tpu_torch.models.network import render_rays as trender
from test_torch_config import (N_RAYS, params_pair, scene_and_volumes,
                               small_configs, torch_jitter)
from tools.paired_jitter import JitterStream, jitter_batch_entry


def test_render_rays_training_matches_jax():
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=4)
    scene, _, _ = scene_and_volumes()
    H, W = scene.img_res
    rng = np.random.default_rng(8)
    uv = np.stack([rng.integers(0, W, N_RAYS), rng.integers(0, H, N_RAYS)],
                  -1).astype(np.float32)[None]
    pose, intr = scene.poses[1:2], scene.intrinsics[1:2]
    s = jcfg.model.sampler
    feed = JitterStream(9, N_RAYS, s.N_samples_eval, s.N_samples,
                        s.N_samples_extra).step()

    jrender_jit = jax.jit(
        lambda p, c, uv, pose, intr, key, jit: jrender(
            p, c, uv, pose, intr, key, training=True, fast=1, jitter=jit),
        static_argnums=(1,))
    jout = jrender_jit(jp, jcfg.model, jnp.asarray(uv), jnp.asarray(pose),
                       jnp.asarray(intr), jax.random.PRNGKey(0),
                       jitter_batch_entry(feed, s.N_samples_extra))
    tout = trender(tp, tcfg.model, torch.tensor(uv), torch.tensor(pose),
                   torch.tensor(intr), torch.Generator().manual_seed(0),
                   training=True, fast=1,
                   jitter=torch_jitter(feed, s.N_samples_extra))

    for name in ("rgb_values", "depth_values", "weights", "grad_theta"):
        got = getattr(tout, name).detach().numpy()
        want = np.asarray(getattr(jout, name))
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got, want, atol=2e-4, err_msg=name)
    # The rendering carries the parameters' gradient (the eikonal term's
    # double backprop included).
    assert tout.rgb_values.requires_grad and tout.grad_theta.requires_grad
