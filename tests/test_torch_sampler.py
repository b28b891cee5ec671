"""The port's error-bound sampler and its pieces against the JAX package.

Tolerances: z_vals and z_samples_eik within 1e-5 absolute (float32
sums in another order; z spans [0, 6]); merge_sorted_pairs exact (it
only moves values); sample_pdf_from_cdf within 1e-6 (the same
arithmetic on the same bracketing entries).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.models import sampler as jsampler
from s_volsdf_tpu.models.density import get_beta as jget_beta
from s_volsdf_tpu.models.network import sdf_values as jsdf_values
from s_volsdf_tpu.ops import inverse_cdf as jicdf
from s_volsdf_tpu.utils.cameras import get_camera_params as jcam
from s_volsdf_tpu_torch.models import sampler as tsampler
from s_volsdf_tpu_torch.models.density import get_beta as tget_beta
from s_volsdf_tpu_torch.models.network import sampler_sdf_fn
from s_volsdf_tpu_torch.ops import inverse_cdf as ticdf
from test_torch_config import (N_RAYS, params_pair, scene_and_volumes,
                               small_configs, torch_jitter)
from tools.paired_jitter import JitterStream, jitter_batch_entry


def _rays(seed, miss=False):
    """(ray_dirs, cam_loc) (R, 3) float32 of random pixels of view 0;
    with miss, half the rays start outside the bounding sphere (r=3)
    and point away from it."""
    scene, _, _ = scene_and_volumes()
    H, W = scene.img_res
    rng = np.random.default_rng(seed)
    uv = np.stack([rng.integers(0, W, N_RAYS), rng.integers(0, H, N_RAYS)],
                  -1).astype(np.float32)
    d, c = jcam(jnp.asarray(uv)[None], jnp.asarray(scene.poses[:1]),
                jnp.asarray(scene.intrinsics[:1]))
    dirs = np.array(d[0])
    cam = np.broadcast_to(np.asarray(c), (N_RAYS, 3)).copy()
    if miss:
        h = N_RAYS // 2
        cam[:h] = np.array([0.0, 0.0, 4.0], np.float32)
        dirs[:h] = dirs[:h] * np.array([0.2, 0.2, 0.0], np.float32) \
            + np.array([0.0, 0.0, 1.0], np.float32)
        dirs[:h] /= np.linalg.norm(dirs[:h], axis=-1, keepdims=True)
    return dirs, cam


def _run_both(training, fast, beta=None, miss=False, seed=0):
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=seed)
    if beta is not None:
        jp["density"]["beta"] = jnp.asarray(beta, jnp.float32)
        with torch.no_grad():
            tp.density.beta.fill_(beta)
    dirs, cam = _rays(seed + 1, miss=miss)
    n_iters = fast if fast >= 0 else jcfg.model.sampler.max_total_iters
    bs = jcfg.model.scene_bounding_sphere
    feed = jitter_j = jitter_t = None
    if training:
        s = jcfg.model.sampler
        feed = JitterStream(seed + 2, N_RAYS, s.N_samples_eval, s.N_samples,
                            s.N_samples_extra).step()
        jitter_j = jitter_batch_entry(feed, s.N_samples_extra)
        jitter_t = torch_jitter(feed, s.N_samples_extra)

    jout = jsampler.error_bound_sample(
        jax.random.PRNGKey(3), jcfg.model.sampler, jnp.asarray(dirs),
        jnp.asarray(cam),
        lambda p: jsdf_values(jp["sdf"], jcfg.model, p, bs),
        jget_beta(jp["density"], jcfg.model.density.beta_min),
        n_iters=n_iters, training=training, scene_bounding_sphere=bs,
        jitter=jitter_j)
    tout = tsampler.error_bound_sample(
        torch.Generator().manual_seed(3), tcfg.model.sampler,
        torch.tensor(dirs), torch.tensor(cam),
        sampler_sdf_fn(tp, tcfg.model, bs),
        tget_beta(tp.density, tcfg.model.density.beta_min).detach(),
        n_iters=n_iters, training=training, scene_bounding_sphere=bs,
        jitter=jitter_t)
    return jout, tout


def _check(jout, tout):
    assert tout.z_vals.shape == jout.z_vals.shape
    np.testing.assert_allclose(tout.z_vals.numpy(), np.asarray(jout.z_vals),
                               atol=1e-5)
    assert tout.converged_iter == int(jout.converged_iter)


def test_training_fast1_with_jitter():
    jout, tout = _run_both(training=True, fast=1)
    _check(jout, tout)
    np.testing.assert_allclose(tout.z_samples_eik.numpy(),
                               np.asarray(jout.z_samples_eik), atol=1e-5)


def test_eval_full_schedule():
    jout, tout = _run_both(training=False, fast=-1)
    _check(jout, tout)


def test_eval_every_ray_converges_dup_branch():
    """A large beta0 passes every ray's error test at the first
    iteration: the global early exit engages and the remaining refine
    iterations take the `dup` branch."""
    jout, tout = _run_both(training=False, fast=-1, beta=5.0)
    assert int(jout.converged_iter) == 1 and tout.converged_iter == 1
    _check(jout, tout)


@pytest.mark.parametrize("training,fast", [(True, 1), (False, -1)])
def test_rays_missing_the_sphere(training, fast):
    jout, tout = _run_both(training=training, fast=fast, miss=True)
    _check(jout, tout)


def test_merge_sorted_pairs_ties_and_nans_exact():
    rng = np.random.default_rng(5)
    R, n1, n2 = 8, 12, 10
    za = np.sort(rng.integers(0, 6, (R, n1)).astype(np.float32), axis=1)
    zb = np.sort(rng.integers(0, 6, (R, n2)).astype(np.float32), axis=1)
    za[1, 8:] = np.nan          # NaN tails rank as +inf
    zb[2, 5:] = np.nan
    za[3] = np.nan              # whole rays that missed
    zb[3] = np.nan
    sa = np.arange(R * n1, dtype=np.float32).reshape(R, n1)
    sb = 1000 + np.arange(R * n2, dtype=np.float32).reshape(R, n2)
    jz, js = jsampler.merge_sorted_pairs(*map(jnp.asarray, (za, sa, zb, sb)))
    tz, ts = tsampler.merge_sorted_pairs(*map(torch.tensor, (za, sa, zb, sb)))
    np.testing.assert_array_equal(tz.numpy(), np.asarray(jz))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_sample_pdf_from_cdf():
    rng = np.random.default_rng(6)
    R, K, N = 16, 24, 20
    bins = np.sort(rng.uniform(0.0, 6.0, (R, K)), axis=1).astype(np.float32)
    pdf = rng.uniform(0.0, 1.0, (R, K - 1)).astype(np.float32)
    pdf[:, 3:6] = 0.0           # flat CDF runs (denominator guard)
    u = np.concatenate([rng.uniform(0, 1, (R, N - 2)),
                        np.zeros((R, 1)), np.ones((R, 1))], axis=1)
    u = np.sort(u, axis=1).astype(np.float32)
    jcdf = jicdf.pdf_to_cdf(jnp.asarray(pdf))
    tcdf = ticdf.pdf_to_cdf(torch.tensor(pdf))
    np.testing.assert_allclose(tcdf.numpy(), np.asarray(jcdf), atol=1e-6)
    # Both sides invert the same CDF: the cumsums above differ in order.
    cdf = np.asarray(jcdf)
    js = jicdf.sample_pdf_from_cdf(jnp.asarray(bins), jnp.asarray(cdf),
                                   jnp.asarray(u))
    ts = ticdf.sample_pdf_from_cdf(torch.tensor(bins), torch.tensor(cdf),
                                   torch.tensor(u))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
