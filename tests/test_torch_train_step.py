"""The port's loss, gradients, optimizer, steps and NaN guard against
the JAX package's, on injected batches with the same jitter feed.

Tolerances and why:
  * compute_loss: rtol 1e-5 — the same float32 reductions.
  * gradients of one step: rtol 1e-3, atol 1e-5 per leaf — double
    backprop sums in another order.
  * clip + Adam on identical gradients: atol 1e-6 on params and moments.
  * five steps: each loss within rtol 1e-2 — Adam's first steps turn
    sign flips of near-zero gradients into whole learning-rate steps, so
    the trajectories are compared loosely and the gradients tightly.
  * at the JAX defaults (bf16 products and activations in the training
    render, the volumes read as bf16): the loss within rtol 1e-3
    (measured 3.6e-4: the eikonal term's spatial gradients run through
    bf16 activations, whose cotangents both sides round after every
    backward op, after sums in other orders, moving them by a bf16 unit
    or two); the whole gradient within 5e-3 relative in L2 (measured
    3.2e-3) and each leaf within 2e-2 (measured up to 5.9e-3). The
    sampler's sweep rounds its bf16 softplus op by op, as JAX does
    (tests/test_torch_trajectory.py); while it rounded the softplus once,
    the loss was 1.4e-3 off, the gradient 7.5e-3 and the radiance MLP's
    first layer 3.4%. Five steps within rtol 2e-2 (measured up to
    9.8e-3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.engine import train_step as jts
from s_volsdf_tpu.models.loss import compute_loss as jloss
from s_volsdf_tpu_torch.engine import train_step as tts
from s_volsdf_tpu_torch.models.loss import compute_loss as tloss
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import (N_RAYS, OUTSIDE_FAMILY, mvs_pair,
                               outside_configs, params_pair,
                               scene_and_volumes, small_configs, torch_jitter)
from tools.paired_jitter import JitterStream, jitter_batch_entry


def _leaf(tree, name):
    """JAX pytree leaf at a port parameter name like 'sdf.3.v'."""
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return tree


def _batches(n, seed, nan=False):
    """n injected (JAX batch, port batch) pairs with their jitter feeds."""
    jcfg, _ = small_configs()
    scene, _, _ = scene_and_volumes()
    H, W = scene.img_res
    s = jcfg.model.sampler
    stream = JitterStream(seed, N_RAYS, s.N_samples_eval, s.N_samples,
                          s.N_samples_extra)
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        view = int(rng.integers(0, 3))
        pix = rng.integers(0, H * W, N_RAYS)
        uv = np.stack([pix % W, pix // W], -1).astype(np.float32)[None]
        rgb = scene.images[view].reshape(-1, 3)[pix][None]
        if nan:
            rgb = rgb * np.nan
        onehot = np.eye(3, dtype=np.float32)[view]
        arrays = {"uv": uv, "rgb": rgb, "rgb_smooth": rgb,
                  "pose": scene.poses[view][None],
                  "intrinsics": scene.intrinsics[view][None],
                  "view_onehot": onehot}
        feed = stream.step()
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        jb["jitter"] = jitter_batch_entry(feed, s.N_samples_extra)
        tb = {k: torch.tensor(v) for k, v in arrays.items()}
        tb["jitter"] = torch_jitter(feed, s.N_samples_extra)
        out.append((jb, tb))
    return out


def _mvs():
    scene, prob, z_slab = scene_and_volumes()
    return mvs_pair(scene, prob, z_slab)


def _defaults(cfg):
    """The JAX defaults of the three training precision knobs."""
    cfg.train.train_compute_dtype = "bfloat16"
    cfg.train.train_activation_dtype = "bfloat16"
    cfg.train.mvs_pack_dtype = "bfloat16"
    return cfg


def _default_configs_and_volumes():
    """(JAX config, port config, JAX volumes packed bf16, port volumes
    stored bf16) at the small size with the default precision."""
    jcfg, tcfg = (_defaults(c) for c in small_configs())
    jm, tm = _mvs()
    return (jcfg, tcfg, jts.pack_for_chunk(jcfg, jm),
            tts.pack_for_chunk(tcfg, tm))


@pytest.mark.parametrize("iter_step", [3, 250])
def test_compute_loss_matches_jax(iter_step):
    """Inside the anneal (gated blurred RGB + sparse) and past it."""
    jcfg, tcfg = small_configs()
    rng = np.random.default_rng(iter_step)
    S = 22
    pi = rng.uniform(0, 0.2, (N_RAYS, S)).astype(np.float32)
    pi[:5] = 0.0                 # gate-closed rays
    arrays = {
        "rgb_values": rng.uniform(0, 1, (N_RAYS, 3)),
        "depth_values": rng.uniform(0.5, 4, (N_RAYS, 1)),
        "weights": rng.dirichlet(np.ones(S), N_RAYS),
        "grad_theta": rng.normal(size=(2 * N_RAYS, 3)),
        "pi": pi,
        "pj": rng.uniform(0, 0.4, (N_RAYS, S)),
    }
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    gt = rng.uniform(0, 1, (1, N_RAYS, 3)).astype(np.float32)
    smooth = rng.uniform(0, 1, (1, N_RAYS, 3)).astype(np.float32)
    jo = jloss(jcfg.loss, {k: jnp.asarray(v) for k, v in arrays.items()},
               jnp.asarray(gt), jnp.asarray(smooth),
               jnp.asarray(iter_step, jnp.int32), use_mvs=True)
    to = tloss(tcfg.loss, {k: torch.tensor(v) for k, v in arrays.items()},
               torch.tensor(gt), torch.tensor(smooth), iter_step, use_mvs=True)
    for name in ("loss", "rgb_loss", "eikonal_loss", "mvs_loss",
                 "sparse_loss", "psnr"):
        np.testing.assert_allclose(float(getattr(to, name)),
                                   float(getattr(jo, name)), rtol=1e-5,
                                   err_msg=name)
    assert (float(to.sparse_loss) > 0) == (iter_step < jcfg.loss.anneal_rgb)


def test_step_gradients_match_jax():
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=1)
    jm, tm = _mvs()
    (jb, tb), = _batches(1, seed=21)
    grad_fn = jax.jit(jax.grad(jts._loss_fn, has_aux=True),
                      static_argnums=(1,))
    jgrads, jlo = grad_fn(jp, jcfg, jb, jax.random.PRNGKey(0), jm,
                          jnp.asarray(5, jnp.int32))
    tgrads, tlo = tts.loss_and_grads(tp, tcfg, tb,
                                     torch.Generator().manual_seed(0), tm, 5)
    np.testing.assert_allclose(float(tlo.loss.detach()), float(jlo.loss),
                               rtol=1e-4)
    assert float(jlo.mvs_loss) != 0.0      # the GCE term is live
    names = [n for n, _ in tp.named_parameters()]
    assert len(names) == len(jax.tree.leaves(jp))
    for name, g in zip(names, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(jgrads, name)),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("family", sorted(OUTSIDE_FAMILY))
def test_step_gradients_match_jax_outside_family(family):
    """One step's loss and gradients with an SDF MLP outside the fused
    kernel's family (width 320; skips at 2 and 4), at the float32 bars
    above: the sampler sweeps the plain MLP and packs nothing."""
    jcfg, tcfg = outside_configs(family)
    assert not fused_sdf.supported(tcfg.model)
    jp, tp = params_pair(jcfg, seed=1)
    jm, tm = _mvs()
    (jb, tb), = _batches(1, seed=21)
    grad_fn = jax.jit(jax.grad(jts._loss_fn, has_aux=True),
                      static_argnums=(1,))
    jgrads, jlo = grad_fn(jp, jcfg, jb, jax.random.PRNGKey(0), jm,
                          jnp.asarray(5, jnp.int32))
    builds, sweeps = fused_sdf.pack_sdf.builds, fused_sdf.plain_sweeps
    tgrads, tlo = tts.loss_and_grads(tp, tcfg, tb,
                                     torch.Generator().manual_seed(0), tm, 5)
    assert fused_sdf.pack_sdf.builds == builds
    assert fused_sdf.plain_sweeps > sweeps
    np.testing.assert_allclose(float(tlo.loss.detach()), float(jlo.loss),
                               rtol=1e-4)
    assert float(jlo.mvs_loss) != 0.0
    names = [n for n, _ in tp.named_parameters()]
    assert len(names) == len(jax.tree.leaves(jp))
    for name, g in zip(names, tgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(_leaf(jgrads, name)),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_clip_adam_matches_optax():
    """optax.chain(clip_by_global_norm(1), adam) on identical gradients,
    three updates, the first two clipped."""
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=2)
    tx = jts.make_optimizer(jcfg)
    jstate = tx.init(jp)
    update = jax.jit(tx.update)
    opt = tts.make_optimizer(tcfg, tp)
    names = [n for n, _ in tp.named_parameters()]
    rng = np.random.default_rng(3)
    for scale in (5.0, 2.0, 0.01):
        gnp = {n: (scale * rng.normal(size=p.shape) / np.sqrt(p.numel()
                                                             * len(names)))
               .astype(np.float32) for n, p in tp.named_parameters()}
        jg = jax.tree_util.tree_map_with_path(
            lambda path, _: jnp.asarray(gnp[".".join(
                str(getattr(k, "key", getattr(k, "idx", k))) for k in path)]),
            jp)
        updates, jstate = update(jg, jstate, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, updates)
        opt.apply([torch.tensor(gnp[n]) for n in names])
    adam_state = jstate[1][0]
    for n, p in tp.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(),
                                   np.asarray(_leaf(jp, n)), atol=1e-6,
                                   err_msg=n)
        st = opt.adam.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(),
                                   np.asarray(_leaf(adam_state.mu, n)),
                                   atol=1e-6, err_msg=n)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   np.asarray(_leaf(adam_state.nu, n)),
                                   atol=1e-6, err_msg=n)


def test_five_steps_track_jax():
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=3)
    jm, tm = _mvs()
    tx = jts.make_optimizer(jcfg)
    jstate = jts.init_train_state(jcfg, jp, tx)
    topt = tts.make_optimizer(tcfg, tp)
    tstate = tts.init_train_state(tcfg, tp, topt)
    gen = torch.Generator().manual_seed(0)
    for i, (jb, tb) in enumerate(_batches(5, seed=31)):
        jstate, jlo = jts.train_step(jstate, jb, jax.random.PRNGKey(i), jm,
                                     cfg=jcfg, tx=tx, use_mvs=True)
        tstate, tlo = tts.train_step(tstate, tb, gen, tm, cfg=tcfg, tx=topt,
                                     use_mvs=True)
        assert tlo.grad_finite == 1.0 and float(jlo.grad_finite) == 1.0
        np.testing.assert_allclose(float(tlo.loss), float(jlo.loss),
                                   rtol=1e-2, err_msg=f"step {i}")
    assert tstate.iter_step == int(jstate.iter_step) == 5


def test_step_gradients_match_jax_at_defaults():
    """One step's loss and gradients at the JAX defaults (bf16 products
    and activations in the training render, bf16 volumes)."""
    jcfg, tcfg, jm, tm = _default_configs_and_volumes()
    assert tm.prob.dtype == torch.bfloat16 and tm.z_slab.dtype == torch.float32
    jp, tp = params_pair(jcfg, seed=1)
    (jb, tb), = _batches(1, seed=21)
    grad_fn = jax.jit(jax.grad(jts._loss_fn, has_aux=True),
                      static_argnums=(1,))
    jgrads, jlo = grad_fn(jp, jcfg, jb, jax.random.PRNGKey(0), jm,
                          jnp.asarray(5, jnp.int32))
    tgrads, tlo = tts.loss_and_grads(tp, tcfg, tb,
                                     torch.Generator().manual_seed(0), tm, 5)
    np.testing.assert_allclose(float(tlo.loss.detach()), float(jlo.loss),
                               rtol=1e-3)
    assert float(jlo.mvs_loss) != 0.0
    names = [n for n, _ in tp.named_parameters()]
    num = den = 0.0
    for name, g in zip(names, tgrads):
        want = np.asarray(_leaf(jgrads, name))
        assert g.dtype == torch.float32, name
        err = np.linalg.norm(g.numpy() - want)
        assert err <= 2e-2 * np.linalg.norm(want), (name, err)
        num, den = num + err ** 2, den + np.linalg.norm(want) ** 2
    assert num ** 0.5 <= 5e-3 * den ** 0.5, (num / den) ** 0.5
    # The defaults are not float32: the float32 step's loss differs.
    _, tlo32 = tts.loss_and_grads(tp, small_configs()[1], tb,
                                  torch.Generator().manual_seed(0), _mvs()[1],
                                  5)
    assert float(tlo32.loss.detach()) != float(tlo.loss.detach())


def test_five_steps_track_jax_at_defaults():
    jcfg, tcfg, jm, tm = _default_configs_and_volumes()
    jp, tp = params_pair(jcfg, seed=3)
    tx = jts.make_optimizer(jcfg)
    jstate = jts.init_train_state(jcfg, jp, tx)
    topt = tts.make_optimizer(tcfg, tp)
    tstate = tts.init_train_state(tcfg, tp, topt)
    gen = torch.Generator().manual_seed(0)
    for i, (jb, tb) in enumerate(_batches(5, seed=31)):
        jstate, jlo = jts.train_step(jstate, jb, jax.random.PRNGKey(i), jm,
                                     cfg=jcfg, tx=tx, use_mvs=True)
        tstate, tlo = tts.train_step(tstate, tb, gen, tm, cfg=tcfg, tx=topt,
                                     use_mvs=True)
        assert tlo.grad_finite == 1.0 and float(jlo.grad_finite) == 1.0
        np.testing.assert_allclose(float(tlo.loss), float(jlo.loss),
                                   rtol=2e-2, err_msg=f"step {i}")
    assert tstate.iter_step == int(jstate.iter_step) == 5


def test_nan_batch_leaves_state_unchanged():
    _, tcfg = small_configs()
    jcfg, _ = small_configs()
    _, tp = params_pair(jcfg, seed=5)
    _, tm = _mvs()
    opt = tts.make_optimizer(tcfg, tp)
    state = tts.init_train_state(tcfg, tp, opt)
    gen = torch.Generator().manual_seed(0)
    (_, good), (_, good2) = _batches(2, seed=41)
    state, lo = tts.train_step(state, good, gen, tm, cfg=tcfg, tx=opt,
                               use_mvs=True)
    assert lo.grad_finite == 1.0
    before = {n: p.detach().clone() for n, p in tp.named_parameters()}
    moments = {n: {k: v.clone() for k, v in opt.adam.state[p].items()}
               for n, p in tp.named_parameters()}
    (_, bad), = _batches(1, seed=42, nan=True)
    state, lo = tts.train_step(state, bad, gen, tm, cfg=tcfg, tx=opt,
                               use_mvs=True)
    assert lo.grad_finite == 0.0 and not np.isfinite(float(lo.loss))
    assert state.iter_step == 2
    for n, p in tp.named_parameters():
        torch.testing.assert_close(p.detach(), before[n], rtol=0, atol=0)
        for k, v in opt.adam.state[p].items():
            torch.testing.assert_close(v, moments[n][k], rtol=0, atol=0)
    # The guard is per step: the next finite batch updates again.
    state, lo = tts.train_step(state, good2, gen, tm, cfg=tcfg, tx=opt,
                               use_mvs=True)
    assert lo.grad_finite == 1.0
    assert int(opt.adam.state[next(tp.parameters())]["step"]) == 2
