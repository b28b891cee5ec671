"""The BlendedMVS training step against the JAX package's: the sampler's
inverse_sphere_bg, the loss's background and gate-rescue terms, the
prior's anchor depths, and one whole step with the NeRF++ background
model, on the small bmvs config (test_torch_config.shrink_bmvs).

The JAX package refuses the jitter seam with the background model, so
each JAX step draws from its key; `bg_step_draws` derives those draws in
JAX's split order and the port takes them as its jitter.

Tolerances and the measured errors:
  * sampler: z_vals_bg within 1e-6; z_vals and z_samples_eik within
    1e-5 absolute (the sampler bar of tests/test_torch_sampler.py) on at
    least 90% of the samples and within 1e-3 on all, on the rays that
    hit the sphere (measured: one sample of 352 past 1e-5, at 3.7e-4, in
    training; 18 of 352, up to 9.7e-5, at eval). Fed the JAX SDF's own
    values, the port's sampler still differs so: the two packages'
    normalised cumulative sums (pdf_to_cdf) differ by up to 3.6e-7 (XLA
    and torch sum in other orders), and where the unclamped field's pdf
    is flat that flips the inverse CDF's bin. On rays that miss the
    sphere every uniform sample is `near` up to float32 rounding, not
    sorted at the last bit, where JAX's masked-reduction lookup (it
    needs sorted bins) and the port's searchsorted differ: both put all
    their samples in [0, near], compared within near. The JAX sampler
    fed the derived draws as jitter returns its own jitter-free z_vals
    bit for bit.
  * compute_loss and prior_depth_anchor: rtol 1e-5 (the same float32
    reductions; the anchors are equal).
  * one float32 step: the loss within 2e-4 relative (measured 1.2e-7
    without gate rescue, 6.6e-7 with it) and the whole gradient within
    1e-3 relative in L2 (measured 5.2e-6 and 6.1e-6).
  * five steps at the JAX defaults (bf16 products and activations in the
    foreground's training render, bf16 volumes): each loss within 1%
    relative (measured up to 1.8e-3).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.engine import train_step as jts
from s_volsdf_tpu.models import sampler as jsampler
from s_volsdf_tpu.models.density import get_beta as jget_beta
from s_volsdf_tpu.models.loss import compute_loss as jloss
from s_volsdf_tpu.models.network import sdf_values as jsdf_values
from s_volsdf_tpu.ops.cost_mapping import pack_volumes as jpack
from s_volsdf_tpu.ops.cost_mapping import prior_depth_anchor as janchor
from s_volsdf_tpu_torch.engine import train_step as tts
from s_volsdf_tpu_torch.models import network_bg as tbg
from s_volsdf_tpu_torch.models import sampler as tsampler
from s_volsdf_tpu_torch.models.density import get_beta as tget_beta
from s_volsdf_tpu_torch.models.loss import compute_loss as tloss
from s_volsdf_tpu_torch.models.network import VolSDFParams, sampler_sdf_fn
from s_volsdf_tpu_torch.ops.cost_mapping import prior_depth_anchor
from test_torch_config import (N_RAYS, bg_params_pair, bg_step_draws,
                               mvs_pair, scene_and_volumes,
                               small_bmvs_configs)
from test_torch_sampler import _rays


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _leaf(tree, name):
    """JAX pytree leaf at a port parameter name like 'bg_sdf.3.w'."""
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return tree


# --------------------------------------------------------------------------
# The sampler's inverse_sphere_bg
# --------------------------------------------------------------------------

def _sample_both(training, miss=False, seed=0):
    """JAX's error_bound_sample (drawing from its key) and the port's (fed
    the same draws) with inverse_sphere_bg; returns (JAX output, port
    output, JAX output given the draws as jitter)."""
    jcfg, tcfg = small_bmvs_configs()
    jp, tp = bg_params_pair(jcfg, seed=seed)
    dirs, cam = _rays(seed + 1, miss=miss)
    n_iters = 1 if training else jcfg.model.sampler.max_total_iters
    key = jax.random.PRNGKey(seed + 7)
    k_sample, _ = jax.random.split(key)
    jfeed, tfeed = bg_step_draws(key, N_RAYS, jcfg.model.sampler)

    def jrun(jitter):
        return jsampler.error_bound_sample(
            k_sample, jcfg.model.sampler, jnp.asarray(dirs), jnp.asarray(cam),
            lambda p: jsdf_values(jp["sdf"], jcfg.model, p, 0.0),
            jget_beta(jp["density"], jcfg.model.density.beta_min),
            n_iters=n_iters, training=training, scene_bounding_sphere=3.0,
            jitter=jitter)

    tout = tsampler.error_bound_sample(
        torch.Generator().manual_seed(3), tcfg.model.sampler,
        torch.tensor(dirs), torch.tensor(cam),
        sampler_sdf_fn(tp, tcfg.model, 0.0),
        tget_beta(tp.density, tcfg.model.density.beta_min).detach(),
        n_iters=n_iters, training=training, scene_bounding_sphere=3.0,
        jitter=tfeed if training else None)
    return jrun(None), tout, jrun(jfeed) if training else None


@pytest.mark.parametrize("training,miss", [(True, False), (False, False),
                                           (True, True), (False, True)])
def test_inverse_sphere_bg_matches_jax(training, miss):
    jout, tout, jfed = _sample_both(training, miss)
    S = tout.z_vals.shape[1]
    s = small_bmvs_configs()[1].model.sampler
    assert S == s.N_samples + 2 + s.N_samples_extra
    assert tout.z_vals_bg.shape == (N_RAYS, s.N_samples_inverse_sphere)
    np.testing.assert_allclose(tout.z_vals_bg.numpy(),
                               np.asarray(jout.z_vals_bg), atol=1e-6)
    assert float(tout.z_vals_bg.max()) <= 1.0 / 3.0 + 1e-7
    # The rays that miss (the first half with `miss`) have every sample
    # in [0, near]: both packages put them there, in other orders.
    hit = slice(N_RAYS // 2 if miss else 0, N_RAYS)
    names = ("z_vals",) + (("z_samples_eik",) if training else ())
    for name in names:
        got = getattr(tout, name).numpy()
        want = np.asarray(getattr(jout, name))
        err = np.abs(got[hit] - want[hit])
        assert err.max() <= 1e-3, (name, err.max())
        assert np.mean(err <= 1e-5) >= 0.9, (name, np.mean(err <= 1e-5))
        if miss:
            near = small_bmvs_configs()[1].model.sampler.near
            np.testing.assert_allclose(got[:N_RAYS // 2],
                                       want[:N_RAYS // 2], atol=near)
    if training:
        # The derived draws are JAX's own: fed back as jitter, they give
        # its jitter-free samples bit for bit.
        for name in ("z_vals", "z_samples_eik"):
            np.testing.assert_array_equal(np.asarray(getattr(jfed, name)),
                                          np.asarray(getattr(jout, name)))
    if miss:
        # The final far column is the sphere's exit, unpinned: 0 on the
        # rays that leave the sphere behind them, below `near`.
        h = N_RAYS // 2
        assert (tout.z_vals[:h, 0] == 0.0).all()


def test_sampler_without_background_has_no_bg_samples():
    _, tcfg = small_bmvs_configs()
    jcfg, _ = small_bmvs_configs()
    _, tp = bg_params_pair(jcfg)
    s = dataclasses.replace(tcfg.model.sampler, inverse_sphere_bg=False)
    dirs, cam = _rays(1)
    out = tsampler.error_bound_sample(
        torch.Generator().manual_seed(3), s, torch.tensor(dirs),
        torch.tensor(cam), sampler_sdf_fn(tp, tcfg.model, 3.0),
        tget_beta(tp.density, 1e-4).detach(), n_iters=1, training=True,
        scene_bounding_sphere=3.0)
    assert out.z_vals_bg is None
    assert (out.z_vals[:, -1] == 6.0).all()


# --------------------------------------------------------------------------
# The loss and the prior's anchors
# --------------------------------------------------------------------------

def _loss_outputs(seed):
    rng = np.random.default_rng(seed)
    S = 22
    pi = rng.uniform(0, 0.2, (N_RAYS, S)).astype(np.float32)
    pi[:6] = 0.0                  # gate-closed rays
    arrays = {
        "rgb_values": rng.uniform(0, 1, (N_RAYS, 3)),
        "depth_values": rng.uniform(0.5, 4, (N_RAYS, 1)),
        "depth_values_all": rng.uniform(0.5, 40, (N_RAYS, 1)),
        "weights": rng.dirichlet(np.ones(S), N_RAYS),
        "grad_theta": rng.normal(size=(2 * N_RAYS, 3)),
        "pi": pi,
        "pj": rng.uniform(0, 0.4, (N_RAYS, S)),
        "prior_anchor": rng.uniform(0.5, 4, N_RAYS),
        "prior_peak": rng.uniform(0, 0.05, N_RAYS),
    }
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    gt = rng.uniform(0, 1, (1, N_RAYS, 3)).astype(np.float32)
    return arrays, gt


def _both_losses(jcfg_loss, tcfg_loss, arrays, gt, iter_step=3):
    jo = jloss(jcfg_loss, {k: jnp.asarray(v) for k, v in arrays.items()},
               jnp.asarray(gt), jnp.asarray(gt),
               jnp.asarray(iter_step, jnp.int32), use_mvs=True)
    to = tloss(tcfg_loss, {k: torch.tensor(v) for k, v in arrays.items()},
               torch.tensor(gt), torch.tensor(gt), iter_step, use_mvs=True)
    return jo, to


@pytest.mark.parametrize("gate_rescue", [False, True])
def test_compute_loss_bg_matches_jax(gate_rescue):
    """The sparse term reads depth_values_all; gate rescue adds its pull
    on the closed, informative rays."""
    jcfg, tcfg = small_bmvs_configs()
    jcfg.loss.gate_rescue = tcfg.loss.gate_rescue = gate_rescue
    arrays, gt = _loss_outputs(1)
    jo, to = _both_losses(jcfg.loss, tcfg.loss, arrays, gt)
    for name in ("loss", "rgb_loss", "eikonal_loss", "mvs_loss",
                 "sparse_loss", "rescue_loss", "psnr"):
        np.testing.assert_allclose(float(getattr(to, name)),
                                   float(getattr(jo, name)), rtol=1e-5,
                                   err_msg=name)
    assert (float(to.rescue_loss) > 0) == gate_rescue
    # The sparse term is the background depth's: without it, it differs.
    fg_only = {k: v for k, v in arrays.items() if k != "depth_values_all"}
    _, to_fg = _both_losses(jcfg.loss, tcfg.loss, fg_only, gt)
    assert float(to_fg.sparse_loss) != float(to.sparse_loss)


@pytest.mark.parametrize("knob,value", [("gate_rescue", False),
                                        ("gate_rescue_weight", 0.3),
                                        ("gate_rescue_peak", 0.04)])
def test_gate_rescue_knobs_are_live(knob, value):
    """Each of the three knobs, changed alone from gate rescue on at its
    defaults, changes the loss."""
    _, tcfg = small_bmvs_configs()
    tcfg.loss.gate_rescue = True
    arrays, gt = _loss_outputs(2)
    t = {k: torch.tensor(v) for k, v in arrays.items()}
    base = tloss(tcfg.loss, t, torch.tensor(gt), torch.tensor(gt), 300,
                 use_mvs=True)
    changed = dataclasses.replace(tcfg.loss, **{knob: value})
    other = tloss(changed, t, torch.tensor(gt), torch.tensor(gt), 300,
                  use_mvs=True)
    assert float(other.loss) != float(base.loss)


@pytest.mark.parametrize("inverse_depth", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prior_depth_anchor_matches_jax(inverse_depth, dtype):
    scene, prob, z_slab = scene_and_volumes(inverse_depth=inverse_depth)
    jm, tm = mvs_pair(scene, prob, z_slab, inverse_depth=inverse_depth)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tm = dataclasses.replace(tm, prob=tm.prob.to(getattr(torch, dtype)))
    H, W = scene.img_res
    rng = np.random.default_rng(4)
    uv = np.stack([rng.uniform(0, W - 1, 64), rng.uniform(0, H - 1, 64)],
                  -1).astype(np.float32)
    uv[:4] = [[0, 0], [W - 1, H - 1], [0, H - 1], [W - 1, 0]]   # the edges
    for view in range(3):
        onehot = np.eye(3, dtype=np.float32)[view]
        ja, jpk = janchor(jnp.asarray(uv), jnp.asarray(onehot),
                          jpack(jm, dtype=jdt))
        ta, tpk = prior_depth_anchor(torch.tensor(uv), torch.tensor(onehot),
                                     tm)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=1e-5)
        np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), rtol=1e-5,
                                   atol=1e-7)
        assert (ta.numpy() == 0).any() and (ta.numpy() > 0).any()


# --------------------------------------------------------------------------
# One step, and five
# --------------------------------------------------------------------------

def _batch(seed, key):
    """(JAX batch, port batch with the key's draws as its jitter)."""
    jcfg, _ = small_bmvs_configs()
    scene, _, _ = scene_and_volumes()
    H, W = scene.img_res
    rng = np.random.default_rng(seed)
    view = int(rng.integers(0, 3))
    pix = rng.integers(0, H * W, N_RAYS)
    rgb = scene.images[view].reshape(-1, 3)[pix][None]
    arrays = {"uv": np.stack([pix % W, pix // W], -1).astype(np.float32)[None],
              "rgb": rgb, "rgb_smooth": rgb,
              "pose": scene.poses[view][None],
              "intrinsics": scene.intrinsics[view][None],
              "view_onehot": np.eye(3, dtype=np.float32)[view]}
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    tb = {k: torch.tensor(v) for k, v in arrays.items()}
    tb["jitter"] = bg_step_draws(key, N_RAYS, jcfg.model.sampler)[1]
    return jb, tb


def _mvs(dtype="float32"):
    scene, prob, z_slab = scene_and_volumes()
    jm, tm = mvs_pair(scene, prob, z_slab)
    if dtype == "bfloat16":
        return (jpack(jm, dtype=jnp.bfloat16),
                dataclasses.replace(tm, prob=tm.prob.to(torch.bfloat16)))
    return jm, tm


@pytest.mark.parametrize("gate_rescue", [False, True])
def test_bg_step_gradients_match_jax(gate_rescue):
    """With gate rescue on, the gate's threshold is raised to 0.1 so
    that some rays of the batch are closed with an informative prior
    (at 1e-3 the closed ones are the slab's degenerate edge, peak 0)."""
    jcfg, tcfg = small_bmvs_configs()
    for cfg in (jcfg, tcfg):
        cfg.loss.gate_rescue = gate_rescue
        if gate_rescue:
            cfg.loss.confi = 0.1
    jp, tp = bg_params_pair(jcfg, seed=1)
    jm, tm = _mvs()
    key = jax.random.PRNGKey(11)
    jb, tb = _batch(21, key)
    grad_fn = jax.jit(jax.grad(jts._loss_fn, has_aux=True),
                      static_argnums=(1,))
    jgrads, jlo = grad_fn(jp, jcfg, jb, key, jm, jnp.asarray(5, jnp.int32))
    tgrads, tlo = tts.loss_and_grads(tp, tcfg, tb, None, tm, 5)
    np.testing.assert_allclose(float(tlo.loss.detach()), float(jlo.loss),
                               rtol=2e-4)
    assert float(jlo.mvs_loss) != 0.0
    assert (float(jlo.rescue_loss) != 0.0) == gate_rescue
    names = [n for n, _ in tp.named_parameters()]
    assert len(names) == len(jax.tree.leaves(jp))
    assert any(n.startswith("bg_sdf.") for n in names)
    num = den = 0.0
    for name, g in zip(names, tgrads):
        want = np.asarray(_leaf(jgrads, name))
        num += float(np.sum((g.numpy() - want) ** 2))
        den += float(np.sum(want ** 2))
        if name.startswith("bg_"):
            assert np.abs(want).max() > 0, name     # the background trains
    assert num ** 0.5 <= 1e-3 * den ** 0.5, (num / den) ** 0.5


def test_five_bg_steps_track_jax_at_defaults():
    jcfg, tcfg = small_bmvs_configs()
    for cfg in (jcfg, tcfg):
        cfg.train.train_compute_dtype = "bfloat16"
        cfg.train.train_activation_dtype = "bfloat16"
        cfg.train.mvs_pack_dtype = "bfloat16"
    jp, tp = bg_params_pair(jcfg, seed=3)
    jm, tm = _mvs("bfloat16")
    tx = jts.make_optimizer(jcfg)
    jstate = jts.init_train_state(jcfg, jp, tx)
    topt = tts.make_optimizer(tcfg, tp)
    tstate = tts.init_train_state(tcfg, tp, topt)
    for i in range(5):
        key = jax.random.PRNGKey(100 + i)
        jb, tb = _batch(31 + i, key)
        jstate, jlo = jts.train_step(jstate, jb, key, jm, cfg=jcfg, tx=tx,
                                     use_mvs=True)
        tstate, tlo = tts.train_step(tstate, tb, None, tm, cfg=tcfg, tx=topt,
                                     use_mvs=True)
        assert tlo.grad_finite == 1.0 and float(jlo.grad_finite) == 1.0
        np.testing.assert_allclose(float(tlo.loss), float(jlo.loss),
                                   rtol=1e-2, err_msg=f"step {i}")
    assert tstate.iter_step == int(jstate.iter_step) == 5


@pytest.mark.parametrize("knob,value", [("with_background", False),
                                        ("N_samples_inverse_sphere", 4)])
def test_bg_model_knobs_are_live(knob, value):
    """with_background (the step's loss) and N_samples_inverse_sphere (an
    eval render's colour), each changed alone, change the result."""
    jcfg, tcfg = small_bmvs_configs()
    _, tp = bg_params_pair(jcfg, seed=1)
    if knob == "with_background":
        _, tm = _mvs()
        _, tb = _batch(21, jax.random.PRNGKey(11))
        other = dataclasses.replace(
            tcfg, model=dataclasses.replace(tcfg.model, with_background=False))
        _, a = tts.loss_and_grads(tp, tcfg, tb, None, tm, 5)
        fg = VolSDFParams(tp.sdf, tp.rgb, tp.density)
        _, b = tts.loss_and_grads(fg, other, tb, None, tm, 5)
        assert float(a.loss) != float(b.loss)
        return
    scene, _, _ = scene_and_volumes()
    uv = torch.tensor([[[3.0, 4.0], [10.0, 20.0], [30.0, 2.0]]])
    pose = torch.tensor(scene.poses[:1])
    intr = torch.tensor(scene.intrinsics[:1])
    sampler = dataclasses.replace(tcfg.model.sampler, **{knob: value})
    other = dataclasses.replace(tcfg.model, sampler=sampler)
    with torch.no_grad():
        a = tbg.render_rays_bg(tp, tcfg.model, uv, pose, intr, None,
                               training=False, fast=-1)
        b = tbg.render_rays_bg(tp, other, uv, pose, intr, None,
                               training=False, fast=-1)
    assert (a.rgb_values - b.rgb_values).abs().max() > 0

