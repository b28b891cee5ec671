"""The port's training trajectory against the JAX package's, across the
RGB anneal's boundary, and the port's per-step draws against the JAX
package's default draw sites.

Paired runs: both packages start from the same parameters (JAX's init,
carried across by `bridge`), read the same MVS volumes (the GT prior,
through each package's `get_mvs_input` and `pack_for_chunk`) and
consume the same draws at every step: the port's own
(`draw_step_inputs`: the view, the pixels and the jitter feed), given
to JAX through `tools.paired_jitter.jitter_batch_entry`. Each runs its
own step: JAX's `_loss_fn` under `jax.grad` and its `guarded_update`
(the body of its `train_step`, with the gradient's global norm read
between them), the port's `loss_and_grads` and `guarded_update`.

This file also drives the JAX package's side of the full-width runs
whose rows are committed under runs_torch/ (not part of the test run;
DIR holds the fixture; the port's side without JAX, on the card too, is
tests/test_torch_trajectory_runs.py):

    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py paired \\
        --precision defaults --steps 300 --root DIR --out X.jsonl \\
        [--init port] [--override loss.anneal_rgb=0] [--all every.json]
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py unpaired \\
        --seed 1 --steps 300 --root DIR --out Y.jsonl
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py summarize \\
        --precision defaults --all every.json --out X.jsonl
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py inits \\
        --seeds 16 --out D    # for test_torch_trajectory_runs.py --jax-inits D
"""

import argparse
import dataclasses
import functools
import json
import os
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s_volsdf_tpu import config as jconfig  # noqa: E402
from s_volsdf_tpu.engine import train_step as jts  # noqa: E402
from s_volsdf_tpu_torch.bridge import from_jax_params, to_jax_params  # noqa: E402
from s_volsdf_tpu_torch.engine import train_step as tts  # noqa: E402
from s_volsdf_tpu_torch.tools import trajectory as traj  # noqa: E402
from test_torch_trajectory_runs import chunk_row, every, summary  # noqa: E402
from tools.paired_jitter import jitter_batch_entry  # noqa: E402


# --------------------------------------------------------------------------
# The JAX side of a paired run
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("cfg", "tx"))
def _jax_step(state, batch, mvs, *, cfg, tx):
    """JAX's `train_step` body with the gradient's global norm read
    between the grad and the guard."""
    grads, lo = jax.grad(jts._loss_fn, has_aux=True)(
        state.params, cfg, batch, jax.random.PRNGKey(0), mvs,
        state.iter_step)
    state, lo = jts.guarded_update(tx, state, grads, lo)
    return state, lo, optax.global_norm(grads)


def jax_batch(batch, n_extra):
    """A port batch (`draw_step_inputs`) as the JAX step's batch, its
    jitter feed through `jitter_batch_entry`."""
    out = {k: jnp.asarray(batch[k].numpy()) for k in
           ("uv", "rgb", "rgb_smooth", "pose", "intrinsics", "view_onehot")}
    j = {k: v.numpy() for k, v in batch["jitter"].items()}
    feed = {"t_rand": j["t_rand"], "u_final": j["u_final"],
            "extra_perm": j["extra_idx"], "eik_idx": j["eik_idx"][:, 0],
            "eik_pts": j["eik_pts"]}
    out["jitter"] = jitter_batch_entry(feed, n_extra)
    return out


def run_jax(jcfg, state, tx, mvs, batches):
    """JAX's step on each port batch; a row (`traj.record`) a step."""
    rows = []
    n_extra = jcfg.model.sampler.N_samples_extra
    for batch in batches:
        state, lo, norm = _jax_step(state, jax_batch(batch, n_extra), mvs,
                                    cfg=jcfg, tx=tx)
        beta = abs(float(state.params["density"]["beta"])) \
            + jcfg.model.density.beta_min
        rows.append(traj.record(int(state.iter_step), lo, float(norm), beta))
    return rows


def jax_setup(su, tmp):
    """The JAX package's scene, trainer and volumes for the port's setup
    `su` (`traj.setup`): its own config of the same overrides, its own
    scene loader (held equal to the port's), JAX's init, and the same
    GT-prior outputs through its `get_mvs_input` and `pack_for_chunk`."""
    from s_volsdf_tpu.engine.runner import setup_scene
    cfg = su["cfg"]
    jcfg = jconfig.per_scene_overrides(jconfig.load_config(
        "dtu", overrides=su["overrides"]), "scan106")
    sc = setup_scene(jcfg, "scan106", exps_root=tmp)
    trainer = sc["trainer"]
    ti = trainer.trains_i
    for k in ("rgb", "rgb_smooth", "poses", "intrinsics"):
        # rgb_smooth's blur sums in another order (1.5e-7 apart), the
        # poses' decomposition rounds in another (1e-16)
        np.testing.assert_allclose(np.asarray(getattr(trainer.scene, k)[ti]),
                                   su["scene_cpu"][k].numpy(), rtol=0,
                                   atol=1e-6, err_msg=k)
    trainer.stg = 0
    outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in su["outs"]]
    mvs = jts.pack_for_chunk(jcfg, trainer.get_mvs_input(outs))
    assert jcfg.train.num_pixels == cfg.train.num_pixels
    return jcfg, trainer, mvs


def paired(precision, n_steps, *, root, stream_seed=0, overrides=(),
           init="jax"):
    """Both packages' rows over one stream at `precision`, from JAX's
    init at cfg.seed (init="jax") or the port's (init="port"): (JAX
    rows, port rows)."""
    ovs = traj.precision_overrides(precision) + list(overrides)
    su = traj.setup(root, overrides=ovs, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        jcfg, jtr, jmvs = jax_setup(su, tmp)
    cfg = su["cfg"]
    if init == "port":
        jtr.state = jts.init_train_state(jcfg, jax.tree.map(
            jnp.asarray, to_jax_params(su["trainer"].state.params)), jtr.tx)
    tp = from_jax_params(jax.tree.map(np.asarray, jtr.state.params))
    batches = list(traj.stream(cfg, su["scene_cpu"], n_steps, stream_seed))
    jrows = run_jax(jcfg, jtr.state, jtr.tx, jmvs, batches)
    trows = traj.run_port(cfg, *traj.fresh_state(cfg, tp), su["mvs"],
                          batches, "cpu")
    return jrows, trows


# --------------------------------------------------------------------------
# Unpaired runs: each package's own loop, its own init and draws
# --------------------------------------------------------------------------

def unpaired_jax(su, seed, n_steps, chunk, tmp):
    """The JAX package's trainer loop (`VolTrainer._get_loop`, chunk
    keys split from `trainer.rng`, as tools/run_100k.py drives it) at
    the port setup's fixture and config, with cfg.seed = seed."""
    from s_volsdf_tpu.engine.runner import setup_scene
    jcfg = jconfig.per_scene_overrides(jconfig.load_config(
        "dtu", overrides=su["overrides"] + [f"seed={seed}"]), "scan106")
    trainer = setup_scene(jcfg, "scan106", exps_root=tmp)["trainer"]
    trainer.stg = 0
    outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in su["outs"]]
    mvs = jts.pack_for_chunk(jcfg, trainer.get_mvs_input(outs))
    run_chunk = trainer._get_loop(True)
    ti = trainer.trains_i
    scene = {k: jnp.asarray(getattr(trainer.scene, k)[ti])
             for k in ("rgb", "rgb_smooth", "poses", "intrinsics")}
    rows, psnrs = [], []
    while int(trainer.state.iter_step) < n_steps:
        trainer.rng, sub = jax.random.split(trainer.rng)
        trainer.state, lo = run_chunk(trainer.state,
                                      jax.random.split(sub, chunk), scene, mvs)
        lo = jax.tree.map(np.asarray, lo)
        psnrs += list(lo.psnr)
        step = int(trainer.state.iter_step)
        if step % 50 == 0:
            beta = abs(float(trainer.state.params["density"]["beta"])) \
                + jcfg.model.density.beta_min
            rows.append(chunk_row(
                step, psnrs, {k: getattr(lo, k)[-1] for k in traj.TERMS},
                beta))
            psnrs = []
    return rows


# --------------------------------------------------------------------------
# The port's draws against the JAX package's default draw sites
# --------------------------------------------------------------------------

def jax_default_draws(key, *, n_views, n_pixels, n_rays, scfg, radius):
    """One JAX training step's random draws at its default sites, from
    the step's key in their split order: `sample_train_batch` (k_view,
    k_pix, k_step), `render_rays` (k_step -> k_sample, k_eik: the
    eikonal points U(-r, r)), `error_bound_sample` (k_sample -> k_uniform
    (t_rand), k_final (u_final), k_extra (the permutation's prefix),
    k_eik (eik_idx), k_bg)."""
    k_view, k_pix, k_step = jax.random.split(key, 3)
    k_sample, k_eik_pts = jax.random.split(k_step)
    k_uniform, k_final, k_extra, k_eik, _ = jax.random.split(k_sample, 5)
    n_final = scfg.N_samples + 2 + scfg.N_samples_extra
    return {
        "view": jax.random.randint(k_view, (), 0, n_views),
        "pix": jax.random.randint(k_pix, (n_rays,), 0, n_pixels),
        "t_rand": jax.random.uniform(k_uniform, (n_rays, scfg.N_samples_eval)),
        "u_final": jax.random.uniform(k_final, (n_rays, scfg.N_samples)),
        "extra_idx": jax.random.permutation(
            k_extra, scfg.N_samples_eval)[: scfg.N_samples_extra],
        "eik_idx": jax.random.randint(k_eik, (n_rays, 1), 0, n_final),
        "eik_pts": jax.random.uniform(k_eik_pts, (n_rays, 3), minval=-radius,
                                      maxval=radius),
    }


def port_draws(batch, W, radius):
    """The same draws from a port batch (`draw_step_inputs`); the
    eikonal points as `render_rays` maps the feed, -r + 2r u."""
    j = {k: v.numpy() for k, v in batch["jitter"].items()}
    uv = batch["uv"][0].numpy().astype(np.int64)
    return {"view": int(np.argmax(batch["view_onehot"].numpy())),
            "pix": uv[:, 1] * W + uv[:, 0],
            "t_rand": j["t_rand"], "u_final": j["u_final"],
            "extra_idx": j["extra_idx"], "eik_idx": j["eik_idx"],
            "eik_pts": -radius + 2.0 * radius * j["eik_pts"]}


def _ks(a, b):
    """The two-sample Kolmogorov-Smirnov statistic."""
    a, b = np.sort(np.ravel(a)), np.sort(np.ravel(b))
    grid = np.concatenate([a, b])
    return np.max(np.abs(np.searchsorted(a, grid, side="right") / a.size
                         - np.searchsorted(b, grid, side="right") / b.size))


def _ks_bar(n, m, alpha=1e-4):
    """The KS statistic's critical value at `alpha` for sizes n, m."""
    return np.sqrt(-0.5 * np.log(alpha / 2) * (n + m) / (n * m))


def _chi2_uniform(values, k):
    """Pearson's statistic of integer values against uniform over
    range(k), with its 1e-4 critical value (Wilson-Hilferty)."""
    counts = np.bincount(np.ravel(values), minlength=k)
    e = counts.sum() / k
    stat = np.sum((counts - e) ** 2) / e
    df, z = k - 1, 3.719   # the normal's 1e-4 upper quantile
    return stat, df * (1 - 2 / (9 * df) + z * np.sqrt(2 / (9 * df))) ** 3


def test_draws_match_jax_default_sites():
    """The port's per-step draws (`draw_step_inputs`, which its trainer's
    step makes in the same order from its generator) hold to the JAX
    package's default draw sites in distribution, over 300 steps of 64
    rays at the small size: each draw's shape, dtype class and range;
    the view, the pixels, eik_idx and the extra columns uniform over
    their ranges (chi-square at 1e-4); extra_idx distinct, a prefix of
    a permutation of N_samples_eval; t_rand, u_final and the eikonal
    points' coordinates in distribution the JAX draws' (two-sample KS at
    1e-4), in [0, 1) and (-r, r)."""
    from test_torch_config import small_configs
    _, tcfg = small_configs()
    scfg = tcfg.model.sampler
    V, H, W, R, n = 3, 24, 32, 64, 300
    r = tcfg.model.scene_bounding_sphere
    tcfg.train.num_pixels = R
    tcfg.dataset.img_res = (H, W)
    scene = {"rgb": torch.zeros(V, H * W, 3),
             "rgb_smooth": torch.zeros(V, H * W, 3),
             "poses": torch.eye(4).repeat(V, 1, 1),
             "intrinsics": torch.eye(4).repeat(V, 1, 1)}
    ours = [port_draws(b, W, r) for b in traj.stream(tcfg, scene, n, 5)]
    keys = jax.random.split(jax.random.PRNGKey(5), n)
    draw = jax.jit(functools.partial(
        jax_default_draws, n_views=V, n_pixels=H * W, n_rays=R, scfg=scfg,
        radius=r))
    theirs = [{k: np.asarray(v) for k, v in draw(key).items()}
              for key in keys]
    n_final = scfg.N_samples + 2 + scfg.N_samples_extra
    ranges = {"view": V, "pix": H * W, "eik_idx": n_final,
              "extra_idx": scfg.N_samples_eval}
    for name in ours[0]:
        a = np.stack([d[name] for d in ours])
        b = np.stack([d[name] for d in theirs])
        assert a.shape == b.shape, name
        assert np.issubdtype(a.dtype, np.integer) == np.issubdtype(
            b.dtype, np.integer), name
        if name in ranges:
            k = ranges[name]
            for x in (a, b):
                assert x.min() >= 0 and x.max() == k - 1, name
                stat, bar = _chi2_uniform(x, k)
                assert stat < bar, (name, stat, bar)
        else:
            lo, hi = (-r, r) if name == "eik_pts" else (0.0, 1.0)
            for x in (a, b):
                assert x.min() >= lo and x.max() < hi, name
            assert _ks(a, b) < _ks_bar(a.size, b.size), (name, _ks(a, b))
    extra = np.stack([d["extra_idx"] for d in ours])
    assert all(len(set(row)) == scfg.N_samples_extra for row in extra)
    # the three U[0,1) feeds are independent of one another
    t0 = np.stack([d["t_rand"][:, 0] for d in ours]).ravel()
    u0 = np.stack([d["u_final"][:, 0] for d in ours]).ravel()
    assert abs(np.corrcoef(t0, u0)[0, 1]) < 0.05


# --------------------------------------------------------------------------
# Tier-1: a paired trajectory across the anneal at the small size
# --------------------------------------------------------------------------

SMALL_ANNEAL = 10     # loss.anneal_rgb of the small paired run
SMALL_STEPS = 40
SMALL_RAYS = 64


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small_paired(precision, n_steps=SMALL_STEPS, seed=0):
    """Both packages over one stream at the small size (test_torch_config
    .shrink, 64 rays) on the 24x32 sphere scene and its volumes, with
    loss.anneal_rgb = SMALL_ANNEAL and rgb_smooth the scene's images
    blurred as the scene loader blurs them: (JAX rows, port rows)."""
    from s_volsdf_tpu_torch.utils.image import gaussian_blur
    from test_torch_config import (mvs_pair, params_pair, scene_and_volumes,
                                   small_configs)
    jcfg, tcfg = small_configs()
    for c in (jcfg, tcfg):
        c.loss.anneal_rgb = SMALL_ANNEAL
        c.train.num_pixels = SMALL_RAYS
        c.dataset.img_res = (24, 32)
        if precision == "defaults":
            c.train.train_compute_dtype = "bfloat16"
            c.train.train_activation_dtype = "bfloat16"
            c.train.mvs_pack_dtype = "bfloat16"
    scene, prob, z_slab = scene_and_volumes()
    V = len(scene.images)
    tscene = {
        "rgb": torch.tensor(scene.images.reshape(V, -1, 3)),
        "rgb_smooth": torch.tensor(np.stack([
            gaussian_blur(im, 31, 90).reshape(-1, 3) for im in scene.images])),
        "poses": torch.tensor(scene.poses),
        "intrinsics": torch.tensor(scene.intrinsics)}
    jm, tm = mvs_pair(scene, prob, z_slab)
    jm, tm = jts.pack_for_chunk(jcfg, jm), tts.pack_for_chunk(tcfg, tm)
    jp, tp = params_pair(jcfg, seed=3)
    tx = jts.make_optimizer(jcfg)
    batches = list(traj.stream(tcfg, tscene, n_steps, seed))
    jrows = run_jax(jcfg, jts.init_train_state(jcfg, jp, tx), tx, jm, batches)
    trows = traj.run_port(tcfg, *traj.fresh_state(tcfg, tp), tm, batches,
                          "cpu")
    return jrows, trows


@pytest.mark.parametrize("precision", ["float32", "defaults"])
def test_trajectory_tracks_jax_across_anneal(precision):
    """40 paired steps of both packages' own steps at the small size,
    across the RGB anneal at step 10: at every step each loss term, the
    PSNR and the gradient's global norm within `traj.BARS[precision]`
    (float32: 3e-4 relative, 0.003 dB; the defaults, whose bf16
    roundings move with the sums' order and which Adam then carries:
    2e-2 the total and the MVS term, 3e-2 the RGB and sparse terms, 6e-2
    the eikonal term and the gradient norm, 0.2 dB). The gated RGB term
    is live inside the anneal and the plain one after it."""
    jrows, trows = small_paired(precision)
    bars = dict(traj.BARS[precision])
    bars["grad_norm"] = bars["eikonal_loss"]
    worst = {k: max(traj.diff(k, a[k], b[k]) for a, b in zip(jrows, trows))
             for k in bars}
    print(f"{precision}: worst {worst}")
    assert traj.parted(jrows, trows, bars) == {k: None for k in bars}, worst
    assert all(r["grad_finite"] == 1.0 for r in jrows + trows)
    inside = [r for r in trows if r["step"] <= SMALL_ANNEAL]
    after = [r for r in trows if r["step"] > SMALL_ANNEAL]
    assert any(r["rgb_loss"] > 0 for r in inside)
    assert all(r["sparse_loss"] > 0 for r in inside[:1])
    assert all(r["sparse_loss"] == 0 and r["rgb_loss"] > 0 for r in after)
    assert len(after) == SMALL_STEPS - SMALL_ANNEAL


def test_sampler_sweep_rounds_as_jax():
    """The port's sampler sweep under the training precision (the plain
    route the CPU takes; the card's fused kernel is held to it) computes
    what its training MLP computes (`network.sdf_values`, whose bf16
    softplus runs op by op as the JAX package's bf16 program does):
    within 1e-5 at the dtu width on 4,096 points (measured 9.5e-7). And
    both against the JAX package's `sdf_values` under that precision:
    mean |diff| within 5e-4 (measured 2.0e-4), max within 1e-2 (5.4e-3):
    bf16 roundings that the sums' order moves. With the sweep's softplus
    rounded once, it was 7.4e-3 from the training MLP and 1.2e-3 from
    JAX on average, so its samples, and every term of the step, moved."""
    from s_volsdf_tpu.models.network import sdf_values
    from s_volsdf_tpu_torch.config import dtu_config
    from s_volsdf_tpu_torch.models.network import (sampler_sdf_fn,
                                                   sdf_values as tsdf_values)
    from test_torch_config import params_pair
    jcfg, tcfg = jconfig.dtu_config(), dtu_config()
    jp, tp = params_pair(jcfg, seed=1)
    jm = dataclasses.replace(jcfg.model, compute_dtype="bfloat16",
                             activation_dtype="bfloat16")
    tm = tts.training_model_config(tcfg)
    assert tm.compute_dtype == tm.activation_dtype == "bfloat16"
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (4096, 3)
                                           ).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x: sdf_values(p, jm, x, 3.0))(
        jp["sdf"], pts))
    got = sampler_sdf_fn(tp, tm, 3.0)(torch.tensor(pts)).numpy()
    with torch.no_grad():
        mlp = tsdf_values(tp.sdf, tm, torch.tensor(pts), 3.0).numpy()
    print(f"sweep vs training MLP {np.abs(got - mlp).max():.3e}, vs JAX "
          f"max {np.abs(got - want).max():.3e} mean "
          f"{np.abs(got - want).mean():.3e}")
    np.testing.assert_allclose(got, mlp, rtol=0, atol=1e-5)
    err = np.abs(got - want)
    assert err.mean() <= 5e-4 and err.max() <= 1e-2, (err.mean(), err.max())


# --------------------------------------------------------------------------
# The full-width runs (python tests/test_torch_trajectory.py ...)
# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["paired", "unpaired", "inits",
                                     "summarize"])
    ap.add_argument("--precision", default="defaults",
                    choices=["defaults", "float32"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--root", default=None, help="the fixture's directory")
    ap.add_argument("--init", default="jax", choices=["jax", "port"],
                    help="paired: whose init at cfg.seed both start from")
    ap.add_argument("--seed", type=int, default=0,
                    help="unpaired: cfg.seed of the JAX package's own loop")
    ap.add_argument("--seeds", type=int, default=20,
                    help="inits: JAX's dtu inits of seeds 0 .. N-1, each an "
                         "npz keyed by the port's parameter names, into "
                         "--out (a directory) for "
                         "`test_torch_trajectory_runs.py inits --jax-inits`")
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--override", action="append", default=[],
                    help="paired: a further config override (repeatable), "
                         "e.g. loss.anneal_rgb=0")
    ap.add_argument("--out", required=True, help="JSONL (a row a 50 steps)")
    ap.add_argument("--all", default=None,
                    help="paired: every step's rows of both, as JSON")
    args = ap.parse_args(argv)
    torch.set_num_threads(os.cpu_count())
    t0 = time.time()
    root = args.root or tempfile.mkdtemp()
    tag = {"precision": args.precision, "fixture": "192x256 scan106, GT prior"}
    if args.mode == "summarize":
        # a paired run's every-step rows (--all) as its JSONL: the rows
        # every 50 steps, then `summary`
        with open(args.all) as f:
            both = json.load(f)
        tag = {"device": "cpu", "init": args.init,
               "precision": args.precision,
               "fixture": "192x256 scan106, GT prior",
               "overrides": args.override}
        with open(args.out, "w") as f:
            for jr, tr in zip(every(both["jax"], 50),
                              every(both["port"], 50)):
                for pkg, r in (("jax", jr), ("port", tr)):
                    f.write(json.dumps({"package": pkg, **tag, **r}) + "\n")
            f.write(json.dumps({**tag, **summary(both["jax"],
                                                      both["port"])}) + "\n")
        return
    if args.mode == "inits":
        from s_volsdf_tpu.models.network import init_volsdf_params
        os.makedirs(args.out, exist_ok=True)
        jcfg = jconfig.load_config("dtu")
        for seed in range(args.seeds):
            tp = from_jax_params(jax.tree.map(np.asarray, init_volsdf_params(
                jax.random.PRNGKey(seed), jcfg.model)))
            np.savez(os.path.join(args.out, f"jax_init_seed{seed}.npz"),
                     **{n: p.detach().numpy()
                        for n, p in tp.named_parameters()})
        return
    if args.mode == "paired":
        jrows, trows = paired(args.precision, args.steps, root=root,
                              init=args.init, overrides=args.override)
        tag["overrides"] = args.override
        if args.all:
            with open(args.all, "w") as f:
                json.dump({"jax": jrows, "port": trows}, f)
        rows = []
        for jr, tr in zip(every(jrows, 50), every(trows, 50)):
            for pkg, r in (("jax", jr), ("port", tr)):
                rows.append({"package": pkg, "device": "cpu", "init": args.init,
                             **tag, **r})
        rows.append({"device": "cpu", "init": args.init, **tag,
                     **summary(jrows, trows)})
    else:
        ovs = traj.precision_overrides(args.precision) + [f"seed={args.seed}"]
        su = traj.setup(root, overrides=ovs, device="cpu")
        with tempfile.TemporaryDirectory() as tmp:
            rows = unpaired_jax(su, args.seed, args.steps, args.chunk, tmp)
        rows = [{**tag, "package": "jax", "device": "cpu",
                 "seed": args.seed, **r} for r in rows]
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"{args.mode} {args.precision}: {time.time() - t0:.0f} s")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
