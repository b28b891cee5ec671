"""The port's lockstep multi-scene step (S scenes' stacked parameters
through one step) against the JAX package's `vmap` of its step and
against the port's own serial step, at the small size of the other
tests, on the CPU.

Tolerances and why:
  * 2-D leaves (the serial path): bit for bit against the arithmetic
    before the scene axis existed (`_old_weight`, `_old_apply_linear`).
  * `draw_step_inputs` + `train_step` against `one_step(gen)`: bit for
    bit (the same draws in the same order).
  * a lockstep step against each scene's serial step: the losses bit
    for bit (on the CPU a batched product sums in the single product's
    order); the parameters within 1e-6 of their largest magnitude
    (measured 1.2e-7 after three steps: the backward of the batched
    products sums some gradients in another order, 1 ulp of a few
    leaves, which Adam carries on).
  * against `jax.vmap` of the JAX step: at float32 the bars of
    test_torch_train_step.py's test_step_gradients_match_jax (loss rtol
    1e-4, gradients rtol 1e-3 atol 1e-5); at the defaults (bf16) the
    loss within rtol 1e-2 and each leaf within 1e-1, as
    test_step_gradients_match_jax_at_defaults, and the whole gradient
    within 1e-1 in L2: on these scenes the port's SERIAL step differs
    from JAX by 5.6e-2 (scene 0) and 1.2e-2 (scene 1) in L2 (measured;
    the bf16 roundings of the eikonal term's activations and cotangents,
    that test's docstring), past its 2e-2 bar, which one data set set.
    The stacked step's gradients are held to the port's serial step's
    on the same inputs within 1e-6 in L2 (measured 6e-9 and 1.2e-8),
    so the scene axis adds nothing to that gap. Parameters after the
    step within 2 lr of JAX's (Adam's first step is lr * g / (|g| +
    eps), so a near-zero gradient entry may step by up to lr either
    way) and, at float32, within 1e-6 where |g| > 1e-4.
  * the stacked plain kernels against the per-scene ones: bit for bit.
"""

import copy
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.engine import train_step as jts
from s_volsdf_tpu.engine.trainer import stack_states as jstack
from s_volsdf_tpu_torch.bridge import (from_jax_stacked_state,
                                       to_jax_stacked_state)
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
from s_volsdf_tpu_torch.engine import multiscene
from s_volsdf_tpu_torch.engine import train_step as tts
from s_volsdf_tpu_torch.engine.trainer import (VolTrainer,
                                               make_multiscene_train_fn,
                                               stack_states)
from s_volsdf_tpu_torch.models import layers
from s_volsdf_tpu_torch.models.network import (n_scenes, stack_params,
                                               unstack_params)
from s_volsdf_tpu_torch.ops import cost_mapping as tcm
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import (N_RAYS, mvs_pair, params_pair,
                               scene_and_volumes, small_bmvs_configs,
                               small_configs, torch_jitter)
from tools.paired_jitter import JitterStream, jitter_batch_entry


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the tests' sizes gain nothing from more, and
    the other test processes run beside them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(cfg, seed, chunk_steps=200):
    """A VolTrainer on the small sphere scene with informative float32
    volumes, its weights and generator from `seed`."""
    cfg = copy.deepcopy(cfg)
    cfg.seed = seed
    scene, prob, z_slab = scene_and_volumes(seed=seed)
    t = VolTrainer(cfg, scene_from_synthetic(scene), None, device="cpu",
                   chunk_steps=chunk_steps)
    _, t.mvs = mvs_pair(scene, prob, z_slab)
    return t


def _leaves(params):
    return {n: p.detach().clone() for n, p in params.named_parameters()}


def _old_weight(self):
    return self.g * self.v / torch.linalg.norm(self.v, dim=0, keepdim=True)


def _old_apply_linear(p, x, compute_dtype=None):
    w = p.weight()
    if compute_dtype is None:
        return x @ w + p.b
    return x.to(compute_dtype).float() @ w.to(compute_dtype).float() + p.b


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_serial_path_unchanged(precision, monkeypatch):
    """2-D leaves: apply_linear, and two trainer steps (render, loss,
    backward, Adam), equal the arithmetic before the scene axis, to the
    bit."""
    _, cfg = small_configs()
    if precision == "bfloat16":
        cfg.train.train_compute_dtype = "bfloat16"
        cfg.train.train_activation_dtype = "bfloat16"
    dt = torch.bfloat16 if precision == "bfloat16" else None
    layer = _trainer(cfg, 0).state.params.sdf[1]
    x = torch.randn(50, layer.v.shape[0], generator=torch.Generator()
                    .manual_seed(1))
    new = layers.apply_linear(layer, x, dt)
    runs = []
    for old in (False, True):
        if old:
            monkeypatch.setattr(layers.WeightNormLinear, "weight", _old_weight)
            monkeypatch.setattr(layers, "apply_linear", _old_apply_linear)
            assert torch.equal(layers.apply_linear(layer, x, dt), new)
        t = _trainer(cfg, 0)
        t.run(2)
        runs.append((_leaves(t.state.params), [lo.loss for lo in t.losses]))
    assert runs[0][1] == runs[1][1]
    for n, p in runs[0][0].items():
        assert torch.equal(p, runs[1][0][n]), n


@pytest.mark.parametrize("preset", ["dtu", "bmvs"])
def test_draws_then_step_equal_one_step(preset):
    """draw_step_inputs + train_step on its batch is one_step(gen), to
    the bit (with the background model too, whose draws include
    t_rand_bg)."""
    _, cfg = small_configs() if preset == "dtu" else small_bmvs_configs()
    out = []
    for draws in (False, True):
        t = _trainer(cfg, 3)
        gen, scene = t.gen, t.scene_tensors()
        mvs = tts.pack_for_chunk(cfg, t.mvs)
        n_views, img_res = len(t.trains_i), t.scene.img_res
        if draws:
            batch = tts.draw_step_inputs(scene, gen, cfg=cfg, n_views=n_views,
                                         img_res=img_res, n_rays=N_RAYS)
            state, lo = tts.train_step(t.state, batch, None, mvs, cfg=cfg,
                                       tx=t.tx, use_mvs=True)
        else:
            step = tts.make_one_step(cfg, t.tx, use_mvs=True,
                                     n_views=n_views, img_res=img_res)
            state, lo = step(scene, mvs, t.state, gen)
        out.append((float(lo.loss), _leaves(state.params),
                    gen.get_state()))
    assert out[0][0] == out[1][0]
    assert torch.equal(out[0][2], out[1][2])
    for n, p in out[0][1].items():
        assert torch.equal(p, out[1][1][n]), n


def test_stack_unstack_round_trip():
    _, cfg = small_configs()
    ps = [_trainer(cfg, s).state.params for s in range(3)]
    st = stack_params(ps)
    assert n_scenes(st) == 3 and n_scenes(ps[0]) == 0
    assert st.density.beta.shape == (3,)
    for s, p in enumerate(ps):
        back = unstack_params(st, s)
        for (n, a), (_, b) in zip(p.named_parameters(),
                                  back.named_parameters()):
            assert torch.equal(a, b), n


@pytest.mark.parametrize("S,gate_rescue", [(1, False), (3, False),
                                           (2, True)])
def test_lockstep_tracks_serial(S, gate_rescue):
    """S scenes in lockstep (run_joint, 3 steps) against each scene's
    serial trainer: losses to the bit, parameters within 1e-6 of their
    largest magnitude, the Adam counts and the generators' states
    equal; with loss.gate_rescue, each scene's prior anchors read from
    its own volumes."""
    _, cfg = small_configs()
    cfg.loss.gate_rescue = gate_rescue
    serial = [_trainer(cfg, s) for s in range(S)]
    for t in serial:
        t.run(3)
    joint = [_trainer(cfg, s) for s in range(S)]
    multiscene.run_joint(joint, 3)
    for a, b in zip(serial, joint):
        assert [lo.loss for lo in a.losses] == [lo.loss for lo in b.losses]
        assert b.state.iter_step == 3 and b.epoch == a.epoch
        assert torch.equal(a.gen.get_state(), b.gen.get_state())
        for (n, p), q in zip(a.state.params.named_parameters(),
                             b.state.params.parameters()):
            scale = p.detach().abs().max().item()
            err = (p - q).abs().max().item()
            assert err <= 1e-6 * max(scale, 1.0), (n, err, scale)
            assert int(b.tx.adam.state[q]["step"]) == 3


def _jax_batches(scenes, seed, n_views=3, nan_scene=None):
    """One step's (JAX batch, port batch) for each scene: pixels from
    numpy and a JitterStream feed each."""
    jcfg, _ = small_configs()
    s = jcfg.model.sampler
    rng = np.random.default_rng(seed)
    out = []
    for i, scene in enumerate(scenes):
        H, W = scene.img_res
        stream = JitterStream(seed + i, N_RAYS, s.N_samples_eval, s.N_samples,
                              s.N_samples_extra)
        view = int(rng.integers(0, n_views))
        pix = rng.integers(0, H * W, N_RAYS)
        uv = np.stack([pix % W, pix // W], -1).astype(np.float32)[None]
        rgb = scene.images[view].reshape(-1, 3)[pix][None]
        if i == nan_scene:
            rgb = rgb * np.nan
        arrays = {"uv": uv, "rgb": rgb, "rgb_smooth": rgb,
                  "pose": scene.poses[view][None],
                  "intrinsics": scene.intrinsics[view][None],
                  "view_onehot": np.eye(n_views, dtype=np.float32)[view]}
        feed = stream.step()
        jb = {k: jnp.asarray(v) for k, v in arrays.items()}
        jb["jitter"] = jitter_batch_entry(feed, s.N_samples_extra)
        tb = {k: torch.tensor(v) for k, v in arrays.items()}
        tb["jitter"] = torch_jitter(feed, s.N_samples_extra)
        out.append((jb, tb))
    return out


def _two_scenes(defaults: bool, nan_scene=None):
    """The JAX and port pieces of a 2-scene step: configs, stacked JAX
    state, batches and volumes, and the port's stacked state, batch and
    SceneVolumes."""
    jcfg, tcfg = small_configs()
    if defaults:
        for c in (jcfg, tcfg):
            c.train.train_compute_dtype = "bfloat16"
            c.train.train_activation_dtype = "bfloat16"
            c.train.mvs_pack_dtype = "bfloat16"
    tx = jts.make_optimizer(jcfg)
    jstates, scenes, jvols, tvols = [], [], [], []
    for seed in (0, 1):
        jp, _ = params_pair(jcfg, seed=seed)
        jstates.append(jts.init_train_state(jcfg, jp, tx))
        scene, prob, z_slab = scene_and_volumes(seed=7 + seed)
        scenes.append(scene)
        jm, tm = mvs_pair(scene, prob, z_slab)
        jvols.append(jts.pack_for_chunk(jcfg, jm) if defaults else jm)
        tvols.append(tm)
    jstate = jstack(jstates)
    pairs = _jax_batches(scenes, 21, nan_scene=nan_scene)
    jbatch = jstack([jb for jb, _ in pairs])
    jmvs = jstack(jvols)
    tstate = from_jax_stacked_state(jax.tree.map(np.asarray, jstate), tcfg)
    tbatch = tts.stack_batches([tb for _, tb in pairs])
    _, tmvs = tts.pack_for_chunk_scenes(tcfg, tvols)
    return jcfg, tcfg, tx, jstate, jbatch, jmvs, tstate, tbatch, tmvs


def _leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return tree


@pytest.mark.parametrize("precision", ["float32", "defaults"])
def test_lockstep_step_matches_jax_vmap(precision):
    """One step of 2 scenes against jax.vmap of the JAX train_step on
    stacked states, batches, volumes and jitter: the loss, the
    gradients and the parameters."""
    defaults = precision == "defaults"
    (jcfg, tcfg, tx, jstate, jbatch, jmvs, tstate, tbatch,
     tmvs) = _two_scenes(defaults)
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    grad_fn = jax.jit(jax.vmap(jax.grad(
        lambda p, b, k, m, it: jts._loss_fn(p, jcfg, b, k, m, it),
        has_aux=True), in_axes=(0, 0, 0, 0, None)))
    jgrads, jlo = grad_fn(jstate.params, jbatch, keys, jmvs,
                          jnp.asarray(0, jnp.int32))
    tgrads, tlo = tts.loss_and_grads(tstate.params, tcfg, tbatch, None, tmvs,
                                     0)
    for s in range(2):   # each scene's gradient is its serial step's
        one = {k: tbatch[k][s:s + 1] for k in ("uv", "rgb", "rgb_smooth",
                                               "pose", "intrinsics")}
        one["view_onehot"] = tbatch["view_onehot"][s]
        one["jitter"] = {k: v[s] if k == "extra_idx"
                         else v[s * N_RAYS:(s + 1) * N_RAYS]
                         for k, v in tbatch["jitter"].items()}
        sgrads, _ = tts.loss_and_grads(
            unstack_params(tstate.params, s), tcfg, one, None,
            tcm.check_volumes(tmvs.scenes[s]), 0)
        num = sum(float(torch.sum((a - b[s]) ** 2))
                  for a, b in zip(sgrads, tgrads))
        den = sum(float(torch.sum(a ** 2)) for a in sgrads)
        assert num ** 0.5 <= 1e-6 * den ** 0.5, (s, (num / den) ** 0.5)
    np.testing.assert_allclose(tlo.loss.detach().numpy(),
                               np.asarray(jlo.loss),
                               rtol=1e-2 if defaults else 1e-4)
    assert np.all(np.asarray(jlo.mvs_loss) != 0.0)
    names = [n for n, _ in tstate.params.named_parameters()]
    for s in range(2):
        num = den = 0.0
        for name, g in zip(names, tgrads):
            want = np.asarray(_leaf(jgrads, name))[s]
            got = g[s].numpy()
            if defaults:
                err = np.linalg.norm(got - want)
                assert err <= 1e-1 * np.linalg.norm(want), (s, name, err)
                num, den = num + err ** 2, den + np.linalg.norm(want) ** 2
            else:
                np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5,
                                           err_msg=f"scene {s} {name}")
        assert num ** 0.5 <= 1e-1 * den ** 0.5, (s, (num / den) ** 0.5)
    # The whole step: vmap of jts.train_step against the port's.
    step = jax.jit(jax.vmap(functools.partial(
        jts.train_step, cfg=jcfg, tx=tx, use_mvs=True)))
    jnew, jlo = step(jstate, jbatch, keys, jmvs)
    tnew, tlo = tts.train_step(tstate, tbatch, None, tmvs, cfg=tcfg,
                               tx=tstate.opt_state, use_mvs=True)
    assert tlo.grad_finite == (1.0, 1.0)
    np.testing.assert_array_equal(np.asarray(jlo.grad_finite), [1.0, 1.0])
    back = to_jax_stacked_state(tnew)
    lr = tcfg.train.learning_rate
    for name, g in zip(names, tgrads):
        want = np.asarray(_leaf(jnew.params, name))
        got = _leaf(back["params"], name)
        np.testing.assert_allclose(got, want, rtol=0, atol=2 * lr,
                                   err_msg=name)
        if not defaults:
            big = np.abs(g.numpy()) > 1e-4
            np.testing.assert_allclose(got[big], want[big], rtol=0,
                                       atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(back["count"], [1, 1])
    assert tnew.iter_step == int(np.asarray(jnew.iter_step)[0]) == 1


def test_nan_scene_guard_matches_jax_vmap():
    """NaN in scene 1's RGB: JAX's vmapped guarded_update and the port
    both give grad_finite [1, 0]; scene 1 keeps its parameters, moments
    and Adam count to the bit, scene 0 steps.

    The step is past the RGB anneal (iter_step = loss.anneal_rgb), where
    the RGB term is the plain L1 and a NaN reaches the loss on both
    sides. During the anneal the gated L1 is mean(per_ray * (confi <
    t)): XLA folds the product with the converted mask into a select, so
    JAX's loss stays finite when every NaN ray is gated out, while
    torch's NaN * 0 is NaN (the port skips such a step, JAX takes it)."""
    (jcfg, tcfg, tx, jstate, jbatch, jmvs, tstate, tbatch,
     tmvs) = _two_scenes(False, nan_scene=1)
    k = tcfg.loss.anneal_rgb
    jstate = jstate._replace(iter_step=jnp.full((2,), k, jnp.int32))
    tstate.iter_step = k
    step = jax.jit(jax.vmap(functools.partial(
        jts.train_step, cfg=jcfg, tx=tx, use_mvs=True)))
    keys = jax.random.split(jax.random.PRNGKey(0), 2)
    jnew, jlo = step(jstate, jbatch, keys, jmvs)
    np.testing.assert_array_equal(np.asarray(jlo.grad_finite), [1.0, 0.0])
    before = to_jax_stacked_state(tstate)
    tnew, tlo = tts.train_step(tstate, tbatch, None, tmvs, cfg=tcfg,
                               tx=tstate.opt_state, use_mvs=True)
    assert tlo.grad_finite == (1.0, 0.0)
    after = to_jax_stacked_state(tnew)
    np.testing.assert_array_equal(after["count"], [1, 0])
    np.testing.assert_array_equal(np.asarray(jnew.opt_state[1][0].count),
                                  [1, 0])
    moved = 0
    for tree in ("params", "mu", "nu"):
        for leaf_b, leaf_a in zip(jax.tree.leaves(before[tree]),
                                  jax.tree.leaves(after[tree])):
            np.testing.assert_array_equal(leaf_a[1], leaf_b[1])
            moved += int(not np.array_equal(leaf_a[0], leaf_b[0]))
    assert moved > 0
    for name, _ in tnew.params.named_parameters():
        np.testing.assert_array_equal(_leaf(after["params"], name)[1],
                                      np.asarray(_leaf(jnew.params, name))[1])


def test_stacked_optimizer_matches_serial():
    """StackedOptimizer against each scene's Optimizer (optax's clip,
    torch's Adam) on the same gradients: three updates, the first two
    clipped, scene 1 skipped at the second; parameters, moments and
    counts."""
    _, cfg = small_configs()
    serial = [_trainer(cfg, s) for s in range(2)]
    st = stack_states([t.state for t in serial])
    names = [n for n, _ in st.params.named_parameters()]
    rng = np.random.default_rng(3)
    for i, scale in enumerate((5.0, 2.0, 0.01)):
        ok = [True, i != 1]
        grads = [torch.tensor((scale * rng.normal(size=p.shape) / np.sqrt(
            p[0].numel() * len(names))).astype(np.float32))
            for p in st.params.parameters()]
        st.opt_state.apply(grads, ok)
        for s, t in enumerate(serial):
            if ok[s]:
                t.tx.apply([g[s] for g in grads])
    assert [st.opt_state.count(s) for s in range(2)] == [3, 2]
    for s, t in enumerate(serial):
        for l, ((n, p), q) in enumerate(zip(t.state.params.named_parameters(),
                                            st.params.parameters())):
            torch.testing.assert_close(q[s], p.detach(), rtol=0, atol=1e-7,
                                       msg=n)
            adam = t.tx.adam.state[p]
            assert int(adam["step"]) == st.opt_state.count(s)
            torch.testing.assert_close(st.opt_state.exp_avg[l][s],
                                       adam["exp_avg"], rtol=0, atol=1e-8)
            torch.testing.assert_close(st.opt_state.exp_avg_sq[l][s],
                                       adam["exp_avg_sq"], rtol=0, atol=1e-9)
    # Handing the state back gives each trainer its scene's.
    fresh = _trainer(cfg, 0)
    st.opt_state.write_back(1, fresh.tx)
    p0 = next(fresh.state.params.parameters())
    assert int(fresh.tx.adam.state[p0]["step"]) == 2


def test_stacked_plain_kernels_equal_per_scene():
    """sdf_values_plain of stacked parameters, pack_sdf_scenes and
    cost_mapping_plain of SceneVolumes equal the per-scene versions bit
    for bit; scenes of different shapes are refused."""
    _, cfg = small_configs()
    ps = [_trainer(cfg, s).state.params for s in range(3)]
    st = stack_params(ps)
    pts = torch.randn(3, 200, 3, generator=torch.Generator().manual_seed(0))
    for mcfg in (cfg.model, tts.training_model_config(cfg)):
        got = fused_sdf.sdf_values_plain(st.sdf, mcfg, pts, 3.0)
        via = fused_sdf.fused_sdf_values(st.sdf, mcfg, pts, 3.0)
        for s, p in enumerate(ps):
            want = fused_sdf.sdf_values_plain(p.sdf, mcfg, pts[s], 3.0)
            assert torch.equal(got[s], want) and torch.equal(via[s], want)
    for mcfg in (cfg.model, tts.training_model_config(cfg)):
        pack = fused_sdf.pack_sdf_scenes(st.sdf, mcfg)
        assert pack.scenes == 3 and pack.vec.shape[1] % 4 == 0
        for s, p in enumerate(ps):
            one = fused_sdf.pack_sdf(p.sdf, mcfg)
            assert torch.equal(pack.weights[s], one.weights)
            assert torch.equal(pack.vec[s, :one.vec.numel()], one.vec)
            assert not pack.vec[s, one.vec.numel():].any()
    with pytest.raises(ValueError, match="pack of 3 scenes"):
        fused_sdf.fused_sdf_values(ps[0].sdf, cfg.model, pts[0], 3.0,
                                   pack=pack)
    with pytest.raises(ValueError, match="S, N, 3"):
        fused_sdf.fused_sdf_values(st.sdf, cfg.model, pts[0], 3.0)

    vols = []
    for s in range(3):
        scene, prob, z_slab = scene_and_volumes(seed=7 + s)
        vols.append(mvs_pair(scene, prob, z_slab)[1])
    stacked = tcm.check_volumes_scenes(vols)
    xyz = torch.rand(3, 16, 24, 3, generator=torch.Generator().manual_seed(2)
                     ) * 4 - 2
    onehot = torch.eye(3)[[0, 2, 1]]
    got = tcm.cost_mapping(None, xyz, onehot, stacked)
    for s, m in enumerate(vols):
        want = tcm.cost_mapping_plain(xyz[s], onehot[s], m)
        for a, b in zip(got, want):
            assert torch.equal(a[s], b)
    assert stacked.kernel.packed[0].shape == (3, 3, 16, 12, 16, 8)
    with pytest.raises(ValueError, match="one lockstep launch"):
        tcm.check_volumes_scenes([vols[0], dataclasses.replace(
            vols[1], prob=vols[1].prob[:, :8].contiguous())])


def test_multiscene_training_improves_every_scene():
    """The port's counterpart of the JAX package's test of the same
    name: 3 scenes (spheres of radius 0.5, 0.65, 0.8) from 3 seeds, 40
    lockstep steps without volumes; every scene's loss falls and its
    PSNR rises, and the states advance together."""
    _, cfg = small_configs()
    cfg.use_mvs = False
    cfg.train.num_pixels = 64
    S, T = 3, 40
    trainers = []
    for i in range(S):
        c = copy.deepcopy(cfg)
        c.seed = i
        scene = make_sphere_scene(3, (32, 48), sphere_radius=0.5 + 0.15 * i)
        trainers.append(VolTrainer(c, scene_from_synthetic(scene), None,
                                   device="cpu"))
    state = stack_states([t.state for t in trainers])
    run = make_multiscene_train_fn(cfg, state.opt_state, use_mvs=False,
                                   n_views=3, img_res=(32, 48))
    state, losses, _ = run(state, T, [t.scene_tensors() for t in trainers],
                           None, [t.gen for t in trainers])
    loss = np.stack([lo.loss.numpy() for lo in losses], 1)    # (S, T)
    psnr = np.stack([lo.psnr.numpy() for lo in losses], 1)
    assert loss.shape == (S, T)
    for s in range(S):
        assert np.isfinite(loss[s]).all()
        assert loss[s, -5:].mean() < loss[s, :5].mean(), f"scene {s}"
        assert psnr[s, -5:].mean() > psnr[s, :5].mean(), f"scene {s}"
    assert state.iter_step == T
    assert [state.opt_state.count(s) for s in range(S)] == [T] * S


def test_stacked_render_refuses_what_ties_scenes():
    """A stacked render takes training fast=1 with the jitter feed only;
    states at different steps do not stack; scenes of different image
    sizes do not run jointly."""
    _, cfg = small_configs()
    ts = [_trainer(cfg, s) for s in range(2)]
    st = stack_params([t.state.params for t in ts])
    uv = torch.zeros(2, 4, 2)
    pose = torch.eye(4).expand(2, 4, 4).contiguous()
    from s_volsdf_tpu_torch.models.network import render_rays
    for kw in ({"training": True, "fast": 2, "jitter": {}},
               {"training": True, "fast": 1, "jitter": None},
               {"training": False, "fast": 1, "jitter": {}}):
        with pytest.raises(ValueError, match="fast=1"):
            render_rays(st, cfg.model, uv, pose, pose, None, **kw)
    ts[1].state.iter_step = 5
    with pytest.raises(ValueError, match="one step"):
        stack_states([t.state for t in ts])
    ts[1].state.iter_step = 0
    small = make_sphere_scene(3, (16, 24))
    ts[1].scene = scene_from_synthetic(small)
    with pytest.raises(ValueError, match="one shape"):
        multiscene.run_joint(ts, 2)


def test_lockstep_background_model_tracks_serial():
    """The NeRF++ background model (the bmvs preset's small size) in
    lockstep: 2 scenes, 2 steps, against each scene's serial trainer, at
    the bars of test_lockstep_tracks_serial."""
    _, cfg = small_bmvs_configs()
    serial = [_trainer(cfg, s) for s in range(2)]
    for t in serial:
        t.run(2)
    joint = [_trainer(cfg, s) for s in range(2)]
    multiscene.run_joint(joint, 2)
    for a, b in zip(serial, joint):
        assert [lo.loss for lo in a.losses] == [lo.loss for lo in b.losses]
        assert torch.equal(a.gen.get_state(), b.gen.get_state())
        for (n, p), q in zip(a.state.params.named_parameters(),
                             b.state.params.parameters()):
            err = (p - q).abs().max().item()
            assert err <= 1e-6 * max(p.detach().abs().max().item(), 1.0), \
                (n, err)
