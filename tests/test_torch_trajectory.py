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
        [--init port] [--override loss.anneal_rgb=0] [--all every.json] \\
        [--from-state S.npz --seed N]
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py unpaired \\
        --seed 1 --steps 300 --root DIR --out Y.jsonl \\
        [--save-at 250 --state-out S.npz]
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py summarize \\
        --precision defaults --all every.json --out X.jsonl
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py gradients \\
        --precision defaults --from-state S.npz --draws 5 --root DIR \\
        --out G.json [--as-written]   # each term's gradient, both packages
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py logits \\
        --precision defaults --from-state S.npz --root DIR --out L.json
    JAX_PLATFORMS=cpu python tests/test_torch_trajectory.py inits \\
        --seeds 16 --out D    # for test_torch_trajectory_runs.py --jax-inits D

`unpaired --save-at N --state-out S.npz` saves the JAX package's whole
TrainState after step N (a multiple of --chunk) of its own loop: the
parameters, optax's clip and Adam state with its count, and iter_step,
as `leaf_<i>` in JAX's flatten order (the checkpoints' order) beside
`names`, their key paths; the loop and its draws go on unchanged.
`paired --from-state S.npz` starts both packages from such a state (the
port's carried leaf by leaf by name, `utils.checkpoint.
read_named_state`), on the stream of `--seed N`. The port's own loop
from such a state, on the card too, is
`tests/test_torch_trajectory_runs.py own-loop --from-state S.npz`.
Rows at multiples of 50 steps hold the colour diagnostics
(`tools.trajectory.colour_fields`): of the step's batch in a paired
run, of `trajectory.probe_batch` in an own loop.
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


def run_jax(jcfg, state, tx, mvs, batches, diagnose=False):
    """JAX's step on each port batch; a row (`traj.record`) a step, with
    `diagnose` the `traj.diagnosed` ones with the colour diagnostics of
    the step's batch at the parameters its loss was taken at."""
    rows = []
    n_extra = jcfg.model.sampler.N_samples_extra
    for batch in batches:
        jb = jax_batch(batch, n_extra)
        diag = (jax_colour_diagnostics(state.params, jcfg, jb) if diagnose
                and traj.diagnosed(int(state.iter_step) + 1) else None)
        state, lo, norm = _jax_step(state, jb, mvs, cfg=jcfg, tx=tx)
        beta = abs(float(state.params["density"]["beta"])) \
            + jcfg.model.density.beta_min
        rows.append(traj.record(int(state.iter_step), lo, float(norm), beta,
                                diag))
    return rows


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_colour(params, batch, *, cfg):
    """JAX's training render of `batch` (`_loss_fn`'s, at the training
    precision) under `traj.rgb_probe`: (each hidden layer's share of
    zero ReLU units, the sigmoid's outputs, the rendered colour)."""
    from s_volsdf_tpu.models import network as jnet
    mcfg = dataclasses.replace(
        cfg.model, compute_dtype=cfg.train.train_compute_dtype,
        activation_dtype=cfg.train.train_activation_dtype)
    with traj.rgb_probe(jnet, lambda s: jnp.mean(
            (s <= 0.5).astype(jnp.float32))) as calls:
        out = jnet.render_rays(params, mcfg, batch["uv"], batch["pose"],
                               batch["intrinsics"], jax.random.PRNGKey(0),
                               training=True, fast=1, jitter=batch["jitter"])
    zeros, sig = calls[-1]
    return zeros, sig, out.rgb_values


def jax_colour_diagnostics(params, jcfg, jb):
    """`traj.colour_fields` of JAX's training render of the JAX batch
    `jb` (`jax_batch`) at `params`."""
    zeros, sig, rgb = _jax_colour(params, jb, cfg=jcfg)
    return traj.colour_fields([float(z) for z in zeros], np.asarray(sig),
                              np.asarray(rgb))


# --------------------------------------------------------------------------
# A JAX TrainState as one npz, carried into the port
# --------------------------------------------------------------------------

def jax_leaf_names(tree):
    """Each leaf's key path, "/"-joined, in `tree_flatten`'s order."""
    def key(k):
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                return str(getattr(k, attr))
        return str(k)
    return ["/".join(key(k) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def save_jax_state(state, path):
    """A JAX TrainState (the parameters, the optimizer's clip and Adam
    state with its count, iter_step) as one npz: `leaf_<i>` in
    `tree_flatten`'s order (the checkpoints' order) and `names`, their
    key paths, which the port's `utils.checkpoint.read_named_state`
    carries them by."""
    leaves = jax.tree_util.tree_leaves(state)
    np.savez(path, names=np.array(jax_leaf_names(state)),
             **{f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)})


def load_jax_state(path, template):
    """The TrainState `save_jax_state` wrote, in `template`'s tree: the
    names, shapes and dtypes of its leaves must be the template's."""
    with np.load(path) as data:
        names = [str(n) for n in data["names"]]
        leaves = [data[f"leaf_{i}"] for i in range(len(names))]
    assert names == jax_leaf_names(template), path
    for old, new in zip(jax.tree_util.tree_leaves(template), leaves):
        assert (np.shape(old), np.asarray(old).dtype) == (new.shape,
                                                           new.dtype), path
    return jax.tree_util.tree_unflatten(
        jax.tree_util.tree_structure(template),
        [jnp.asarray(x) for x in leaves])


def port_state(cfg, path, device="cpu"):
    """The port's TrainState and optimizer from a `save_jax_state` npz,
    every leaf carried by name (`read_named_state`)."""
    from s_volsdf_tpu_torch.models.network import init_volsdf_params
    from s_volsdf_tpu_torch.utils.checkpoint import read_named_state
    state, tx = traj.fresh_state(cfg, init_volsdf_params(
        torch.Generator(), cfg.model, device))
    read_named_state(path, state)
    return state, tx


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
           init="jax", from_state=None):
    """Both packages' rows over one stream (of seed `stream_seed`) at
    `precision`, from JAX's init at cfg.seed (init="jax"), the port's
    (init="port"), or a saved JAX TrainState (`from_state`, an npz of
    `save_jax_state`): (JAX rows, port rows)."""
    ovs = traj.precision_overrides(precision) + list(overrides)
    su = traj.setup(root, overrides=ovs, device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        jcfg, jtr, jmvs = jax_setup(su, tmp)
    cfg = su["cfg"]
    if init == "port":
        jtr.state = jts.init_train_state(jcfg, jax.tree.map(
            jnp.asarray, to_jax_params(su["trainer"].state.params)), jtr.tx)
    if from_state:
        jtr.state = load_jax_state(from_state, jtr.state)
        tstate = port_state(cfg, from_state)
    else:
        tstate = traj.fresh_state(cfg, from_jax_params(
            jax.tree.map(np.asarray, jtr.state.params)))
    batches = list(traj.stream(cfg, su["scene_cpu"], n_steps, stream_seed))
    jrows = run_jax(jcfg, jtr.state, jtr.tx, jmvs, batches, diagnose=True)
    trows = traj.run_port(cfg, *tstate, su["mvs"], batches, "cpu",
                          diagnose=lambda p, b: traj.colour_diagnostics(
                              p, cfg, b, "cpu"))
    return jrows, trows


def logit_gap(jcfg, jparams, tcfg, tparams, batch):
    """Both packages' radiance sigmoid outputs on one batch's training
    render, compared through their logits h: the medians over samples
    and channels of |h| (JAX's), |h_port - h_jax|, that over |h|, and
    the sigmoids' relative difference. A colour gradient scales with
    sigmoid'(h), about exp(h) where the sigmoid saturates, so there its
    relative difference is the logits' absolute one."""
    from s_volsdf_tpu_torch.engine.train_step import training_model_config
    from s_volsdf_tpu_torch.models import network
    jsig = np.asarray(_jax_colour(jparams, jax_batch(
        batch, jcfg.model.sampler.N_samples_extra), cfg=jcfg)[1],
        np.float64)
    with traj.rgb_probe(network, lambda s: 0.0) as calls:
        network.render_rays(tparams, training_model_config(tcfg),
                            batch["uv"], batch["pose"], batch["intrinsics"],
                            None, training=True, fast=1,
                            jitter=batch["jitter"])
    tsig = calls[-1][1].detach().double().numpy()
    with np.errstate(divide="ignore", invalid="ignore"):
        jh, th = (np.log(x) - np.log1p(-x) for x in (jsig, tsig))
    ok = np.isfinite(jh) & np.isfinite(th) & (jsig > 0)
    dh, ah = np.abs(jh[ok] - th[ok]), np.abs(jh[ok])
    return {"samples": int(ok.sum()), "abs_h": float(np.median(ah)),
            "abs_dh": float(np.median(dh)),
            "rel_dh": float(np.median(dh / np.maximum(ah, 1e-6))),
            "rel_dsig": float(np.median(np.abs(jsig - tsig)[ok]
                                        / jsig[ok]))}


def state_pair(precision, from_state, root):
    """Both packages at full width on `traj.setup`'s fixture, at a saved
    JAX TrainState and at JAX's init at cfg.seed: (setup, JAX config,
    JAX volumes, {"state": (JAX params, port params), "init": (...)},
    iter_step of the state)."""
    su = traj.setup(root, overrides=traj.precision_overrides(precision),
                    device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        jcfg, jtr, jmvs = jax_setup(su, tmp)
    init = jtr.state.params
    jstate = load_jax_state(from_state, jtr.state)
    tstate, _ = port_state(su["cfg"], from_state)
    pairs = {"state": (jstate.params, tstate.params),
             "init": (init, from_jax_params(jax.tree.map(np.asarray, init)))}
    return su, jcfg, jmvs, pairs, tstate.iter_step


def logits_at_state(precision, from_state, *, root, draws=5,
                    stream_seed=0):
    """`logit_gap` at full width on `draws` batches of one stream, at a
    saved JAX TrainState (both packages carrying it) and at JAX's init
    at cfg.seed: [{"draw", "state", "init"}]."""
    su, jcfg, _, pairs, _ = state_pair(precision, from_state, root)
    out = []
    for i, batch in enumerate(traj.stream(su["cfg"], su["scene_cpu"], draws,
                                          stream_seed)):
        out.append({"draw": i, **{
            name: logit_gap(jcfg, jp, su["cfg"], tp, batch)
            for name, (jp, tp) in pairs.items()}})
        print(json.dumps(out[-1]), flush=True)
    return out


def gradients_at_state(precision, from_state, *, root, draws=5,
                       stream_seed=0, as_written=False):
    """`term_gradients` at full width on `draws` batches of one stream,
    at a saved JAX TrainState (both packages carrying it) and, on the
    same batches at the same iter_step, at JAX's init at cfg.seed: the
    baseline a bf16 rounding gives. Each draw's entry also holds both
    packages' colour diagnostics at the state. `as_written`: see
    `term_gradients`."""
    su, jcfg, jmvs, pairs, step = state_pair(precision, from_state, root)
    cfg = su["cfg"]
    jp, tp = pairs["state"]
    n_extra = jcfg.model.sampler.N_samples_extra
    out = []
    for i, batch in enumerate(traj.stream(cfg, su["scene_cpu"], draws,
                                          stream_seed)):
        entry = {"draw": i, "iter_step": step}
        for name, (jq, tq) in pairs.items():
            entry[name] = term_gradients(jcfg, jq, jmvs, cfg, tq, su["mvs"],
                                         batch, step, as_written)
            entry[name + "_outside"] = outside_grad_bars(entry[name])
        entry["colour"] = {
            "jax": jax_colour_diagnostics(jp, jcfg, jax_batch(batch, n_extra)),
            "port": traj.colour_diagnostics(tp, cfg, batch, "cpu")}
        print(json.dumps({k: entry[k] for k in (
            "draw", "state_outside", "init_outside", "colour")}),
              flush=True)
        out.append(entry)
    return out


# --------------------------------------------------------------------------
# Unpaired runs: each package's own loop, its own init and draws
# --------------------------------------------------------------------------

def unpaired_jax(su, seed, n_steps, chunk, tmp, *, save_at=None,
                 state_out=None):
    """The JAX package's trainer loop (`VolTrainer._get_loop`, chunk
    keys split from `trainer.rng`, as tools/run_100k.py drives it) at
    the port setup's fixture and config, with cfg.seed = seed, to step
    n_steps; each row with the colour diagnostics of `traj.probe_batch`.
    The whole state after step `save_at` (a multiple of chunk) goes to
    `state_out` (`save_jax_state`); saving reads the state between
    chunks and leaves the loop's draws as they were."""
    from s_volsdf_tpu.engine.runner import setup_scene
    jcfg = jconfig.per_scene_overrides(jconfig.load_config(
        "dtu", overrides=su["overrides"] + [f"seed={seed}"]), "scan106")
    trainer = setup_scene(jcfg, "scan106", exps_root=tmp)["trainer"]
    trainer.stg = 0
    if save_at is not None and save_at % chunk:
        raise ValueError(f"--save-at {save_at}: not a multiple of {chunk}")
    outs = [{k: v.cpu().numpy() for k, v in o.items()} for o in su["outs"]]
    mvs = jts.pack_for_chunk(jcfg, trainer.get_mvs_input(outs))
    run_chunk = trainer._get_loop(True)
    ti = trainer.trains_i
    scene = {k: jnp.asarray(getattr(trainer.scene, k)[ti])
             for k in ("rgb", "rgb_smooth", "poses", "intrinsics")}
    probe = jax_batch(traj.probe_batch(su["cfg"], su["scene_cpu"]),
                      jcfg.model.sampler.N_samples_extra)
    rows, psnrs = [], []
    while int(trainer.state.iter_step) < n_steps:
        trainer.rng, sub = jax.random.split(trainer.rng)
        trainer.state, lo = run_chunk(trainer.state,
                                      jax.random.split(sub, chunk), scene, mvs)
        lo = jax.tree.map(np.asarray, lo)
        psnrs += list(lo.psnr)
        step = int(trainer.state.iter_step)
        if step == save_at:
            save_jax_state(trainer.state, state_out)
        if step % 50 == 0:
            beta = abs(float(trainer.state.params["density"]["beta"])) \
                + jcfg.model.density.beta_min
            rows.append({**chunk_row(
                step, psnrs, {k: getattr(lo, k)[-1] for k in traj.TERMS},
                beta), **jax_colour_diagnostics(trainer.state.params, jcfg,
                                                probe)})
            print(json.dumps(rows[-1]), flush=True)
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


def small_setup(precision, seed=3):
    """Both packages at the small size (test_torch_config.shrink, 64
    rays) on the 24x32 sphere scene and its volumes, with loss.anneal_rgb
    = SMALL_ANNEAL and rgb_smooth the scene's images blurred as the scene
    loader blurs them: (JAX config, port config, JAX volumes, port
    volumes, JAX params, port params (the same values, JAX's init at
    `seed`), the port's scene tensors)."""
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
    jp, tp = params_pair(jcfg, seed=seed)
    return jcfg, tcfg, jm, tm, jp, tp, tscene


def small_paired(precision, n_steps=SMALL_STEPS, seed=0):
    """Both packages over one stream (of `seed`) at `small_setup`'s size:
    (JAX rows, port rows)."""
    jcfg, tcfg, jm, tm, jp, tp, tscene = small_setup(precision)
    tx = jts.make_optimizer(jcfg)
    batches = list(traj.stream(tcfg, tscene, n_steps, seed))
    jrows = run_jax(jcfg, jts.init_train_state(jcfg, jp, tx), tx, jm, batches)
    trows = traj.run_port(tcfg, *traj.fresh_state(tcfg, tp), tm, batches,
                          "cpu")
    return jrows, trows


# --------------------------------------------------------------------------
# Each loss term's gradient, both packages, at one state
# --------------------------------------------------------------------------

GRAD_TERMS = ("loss", "rgb_loss", "eikonal_loss", "mvs_loss", "sparse_loss")
# The bars of test_torch_train_step.py::test_step_gradients_match_jax_at_
# defaults: a term's value (relative), a leaf's gradient and a group's or
# the whole gradient's (the norm of the difference over the norm of
# JAX's).
GRAD_BARS = {"value": 1e-3, "leaf": 2e-2, "whole": 5e-3}


# XLA's compile option that makes a bf16 program round wherever its jaxpr
# converts to bf16: by default (True) XLA may keep a fusion's bf16
# intermediates in float32, so the JAX package's bf16 program as it runs
# rounds less often than as it is written, which the port computes.
AS_WRITTEN = {"xla_allow_excess_precision": False}


def _jax_term_grads_fn(params, batch, mvs, iter_step, *, cfg):
    """Each GRAD_TERMS term of JAX's `_loss_fn` and its gradient."""
    def term(name):
        return lambda p: getattr(jts._loss_fn(
            p, cfg, batch, jax.random.PRNGKey(0), mvs, iter_step)[1], name)
    return {k: jax.value_and_grad(term(k))(params) for k in GRAD_TERMS}


_jax_term_grads = {
    False: jax.jit(_jax_term_grads_fn, static_argnames=("cfg",)),
    True: jax.jit(_jax_term_grads_fn, static_argnames=("cfg",),
                  compiler_options=AS_WRITTEN)}


def _jax_leaf(tree, name):
    for part in name.split("."):
        tree = tree[int(part)] if part.isdigit() else tree[part]
    return np.asarray(tree)


def term_gradients(jcfg, jparams, jmvs, tcfg, tparams, tmvs, batch,
                   iter_step, as_written=False):
    """Each GRAD_TERMS term's value and gradient in both packages on one
    port batch (JAX's through `jax_batch`) at one state: for each term
    {"jax", "port" (the values), "value" (their `traj.diff`), "leaves"
    (each leaf's |port - JAX| / |JAX|, 0 where both are 0), "groups"
    (the same over the radiance MLP's leaves "rgb", the SDF MLP's "sdf",
    and "whole"), "worst_leaf"}. With `as_written`, JAX's program is
    compiled with AS_WRITTEN."""
    from s_volsdf_tpu_torch.utils.device import full_float32
    jb = jax_batch(batch, jcfg.model.sampler.N_samples_extra)
    jout = _jax_term_grads[as_written](
        jparams, jb, jmvs, jnp.asarray(iter_step, jnp.int32), cfg=jcfg)
    names = [n for n, _ in tparams.named_parameters()]
    plist = list(tparams.parameters())
    with full_float32():
        _, lo = tts._loss_fn(tparams, tcfg, batch, None, tmvs, iter_step)
        tout = {}
        for k in GRAD_TERMS:
            t = getattr(lo, k)
            gs = (torch.autograd.grad(t, plist, retain_graph=True,
                                      allow_unused=True)
                  if t.requires_grad else [None] * len(plist))
            tout[k] = (float(t.detach()), [
                torch.zeros_like(p) if g is None else g.detach()
                for p, g in zip(plist, gs)])
    out = {}
    for k in GRAD_TERMS:
        jval, jgrad = jout[k]
        tval, tgrad = tout[k]
        sq = {"rgb": [0.0, 0.0], "sdf": [0.0, 0.0], "whole": [0.0, 0.0]}
        leaves = {}
        for name, g in zip(names, tgrad):
            want = _jax_leaf(jgrad, name)
            err = float(np.linalg.norm(g.numpy() - want))
            ref = float(np.linalg.norm(want))
            leaves[name] = err / ref if ref > 0 else (0.0 if err == 0
                                                      else float("inf"))
            for grp in ("whole", name.split(".")[0]):
                if grp in sq:
                    sq[grp][0] += err ** 2
                    sq[grp][1] += ref ** 2
        groups = {g: (e ** 0.5 / r ** 0.5 if r > 0 else
                      (0.0 if e == 0 else float("inf")))
                  for g, (e, r) in sq.items()}
        worst = max(leaves, key=leaves.get)
        out[k] = {"jax": float(jval), "port": tval,
                  "value": traj.diff(k, float(jval), tval),
                  "leaves": leaves, "groups": groups,
                  "worst_leaf": [worst, leaves[worst]]}
    return out


def outside_grad_bars(terms):
    """The terms, leaves and groups of `term_gradients`' result outside
    GRAD_BARS: [(term, what, value)]."""
    out = []
    for k, t in terms.items():
        if t["value"] > GRAD_BARS["value"]:
            out.append((k, "value", t["value"]))
        out += [(k, n, e) for n, e in t["leaves"].items()
                if e > GRAD_BARS["leaf"]]
        out += [(k, g, e) for g, e in t["groups"].items()
                if e > GRAD_BARS["whole"]]
    return out


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


def saturated_colour_state(precision):
    """`small_setup` with JAX's init pushed to the post-anneal colour
    plateau's kind of field: the radiance MLP's last bias +8 on the red
    channel (its sigmoid saturates) and -4 on every other unit of each
    hidden layer (their ReLUs go dead); carried into the port."""
    jcfg, tcfg, jm, tm, jp, _, tscene = small_setup(precision)
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jp)
    tree["rgb"][-1]["b"][0] += 8.0
    for layer in tree["rgb"][:-1]:
        layer["b"][::2] -= 4.0
    return (jcfg, tcfg, jm, tm, jax.tree.map(jnp.asarray, tree),
            from_jax_params(tree), tscene)


# At the defaults, the SDF MLP's leaves and groups of each term against
# these, not GRAD_BARS: its bf16 second derivative (the eikonal term's)
# puts the eikonal term's SDF gradient 1.0-1.3% apart and a leaf up to
# 4.1% at this size, the total's SDF leaves up to 2.0% (measured); with
# the softplus derivative autograd took of its three ops (the port at
# 19839b1) 2.5-4.2% and 6.4%, and the eikonal value 1.3-1.4e-3.
BF16_SDF_BARS = {"leaf": 5e-2, "group": 2e-2}


@pytest.mark.parametrize("precision", ["float32", "defaults"])
def test_gradients_match_jax_past_anneal_at_saturated_colour(precision):
    """Past the anneal (iter_step = SMALL_ANNEAL + 5), with the red
    channel's sigmoid saturated and about half of each hidden layer's
    ReLUs dead (`saturated_colour_state`; both read back by the colour
    diagnostics of both packages, which agree), each loss term's value
    and gradient in both packages on two draws: every term (total, RGB
    L1, eikonal, GCE, sparse) within GRAD_BARS on its value, each leaf,
    the radiance MLP's and the SDF MLP's leaves together and the whole
    gradient; at the defaults the SDF MLP's leaves and the SDF and whole
    groups within BF16_SDF_BARS instead, every term's value and every
    radiance leaf still within GRAD_BARS.

    The red logits sit near 8, not at the 45 of the JAX package's
    plateau state (PERF.md §6): there the gradients of the radiance
    MLP vanish in float32 at this size, so this test cannot see the
    radiance gradient's 1.4-2.2% gap at that state, which the
    full-width `gradients` mode of this file reads."""
    jcfg, tcfg, jm, tm, jp, tp, tscene = saturated_colour_state(precision)
    step = SMALL_ANNEAL + 5
    for batch in traj.stream(tcfg, tscene, 2, 11):
        jd = jax_colour_diagnostics(
            jp, jcfg, jax_batch(batch, jcfg.model.sampler.N_samples_extra))
        td = traj.colour_diagnostics(tp, tcfg, batch, "cpu")
        for d in (jd, td):
            assert d["sigmoid_saturated"][0] > 0.9, d
            assert all(0.3 < z < 0.9 for z in d["relu_zero"]), d
        np.testing.assert_allclose(td["relu_zero"], jd["relu_zero"],
                                   atol=1e-2)
        np.testing.assert_allclose(td["rgb_mean"], jd["rgb_mean"], atol=1e-3)
        terms = term_gradients(jcfg, jp, jm, tcfg, tp, tm, batch, step)
        assert terms["sparse_loss"]["jax"] == terms["sparse_loss"]["port"] \
            == 0.0
        assert terms["rgb_loss"]["jax"] > 0
        outside = outside_grad_bars(terms)
        if precision == "defaults":
            outside = [(k, w, e) for k, w, e in outside
                       if not (w.startswith("sdf") or w == "whole")
                       or e > BF16_SDF_BARS[
                           "leaf" if w.startswith("sdf.") else "group"]]
        assert outside == [], outside


def test_jax_state_carried_mid_run(tmp_path):
    """A JAX TrainState after 14 steps of JAX's step past a tiny anneal
    (SMALL_ANNEAL, float32, the small size), saved as one npz
    (`save_jax_state`) and carried into the port by name
    (`read_named_state`): every parameter, Adam moment and the count
    bit-equal and iter_step equal; JAX's own loader gives the state back
    bit for bit; a leaf that is misnamed, or two leaves swapped, raise.
    Then the next step of both packages on one batch within
    `traj.BARS["float32"]` on every term."""
    from s_volsdf_tpu_torch.bridge import _adam_state
    jcfg, tcfg, jm, tm, jp, _, tscene = small_setup("float32")
    tx = jts.make_optimizer(jcfg)
    state = jts.init_train_state(jcfg, jp, tx)
    batches = list(traj.stream(tcfg, tscene, SMALL_ANNEAL + 5, 4))
    n_extra = jcfg.model.sampler.N_samples_extra
    for b in batches[:-1]:
        state, _, _ = _jax_step(state, jax_batch(b, n_extra), jm, cfg=jcfg,
                                tx=tx)
    path = str(tmp_path / "state.npz")
    save_jax_state(state, path)
    back = load_jax_state(path, jts.init_train_state(jcfg, jp, tx))
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    tstate, topt = port_state(tcfg, path)
    assert tstate.iter_step == int(state.iter_step) == SMALL_ANNEAL + 4
    adam = _adam_state(state.opt_state)
    for name, p in tstate.params.named_parameters():
        st = topt.adam.state[p]
        for got, want in ((p, state.params), (st["exp_avg"], adam.mu),
                          (st["exp_avg_sq"], adam.nu)):
            np.testing.assert_array_equal(got.detach().numpy(),
                                          _jax_leaf(want, name), name)
        assert float(st["step"]) == int(adam.count) == SMALL_ANNEAL + 4
    with np.load(path) as data:
        arrays = dict(data)
    names = list(arrays["names"])
    for bad in ([names[0] + "x"] + names[1:],
                [names[1], names[0]] + names[2:]):
        np.savez(path, **{**arrays, "names": np.array(bad)})
        with pytest.raises((ValueError, KeyError)):
            port_state(tcfg, path)
    jrow = run_jax(jcfg, state, tx, jm, batches[-1:])[0]
    trow = traj.run_port(tcfg, tstate, topt, tm, batches[-1:], "cpu")[0]
    assert jrow["step"] == trow["step"] == SMALL_ANNEAL + 5
    assert traj.parted([jrow], [trow], traj.BARS["float32"]) == \
        dict.fromkeys(traj.BARS["float32"]), (jrow, trow)


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


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_softplus_derivatives_are_jaxs(dtype):
    """The port's softplus(100 x)/100 (`layers.softplus_b`) against the
    JAX package's (`layers.softplus_b`, jax.nn.softplus) on 60,000
    activations at the SDF MLP's scales (|x| about 0.003 to 1), in both
    packages' bf16 or float32: its first derivative (a vector-Jacobian
    product) and its second (the gradient of sum(w * softplus'(x)), the
    route of the eikonal term's parameter gradient). bf16, where the
    port takes JAX's rule: equal to the bit, but where both are under
    1e-30 (denormals one package flushes). With the derivative autograd
    takes of the forward's three ops (the port at 19839b1) the bf16
    first derivative is 1 - 2^-8 where JAX's, exp(x - softplus(x)), is
    1: a one-signed gap that made the bf16 spatial gradient of a trained
    SDF 0.5% shorter than JAX's and its eikonal term 1-2% smaller
    (PERF.md §6). float32, where the port keeps autograd's
    derivative: within 2e-6 of the largest of JAX's (measured 4.4e-7
    and 1.6e-6)."""
    from s_volsdf_tpu.models.layers import softplus_b as jsoftplus
    from s_volsdf_tpu_torch.models.layers import softplus_b
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, s, 20000) for s in (0.003, 0.03, 0.3)]
                       ).astype(np.float32)
    w = rng.normal(1, 0.3, x.shape).astype(np.float32)
    xj = jnp.asarray(x).astype(jdt)

    def jfirst(x, w):
        return jax.vjp(jsoftplus, x)[1](w.astype(jdt))[0]

    def jsecond(x, w):
        def slope(y):
            return jax.grad(lambda z: jnp.sum(jsoftplus(z).astype(
                jnp.float32)))(y).astype(jnp.float32)
        return jax.grad(lambda y: jnp.sum(w * slope(y)))(x)

    want = [np.asarray(jax.jit(f)(xj, jnp.asarray(w)).astype(jnp.float32))
            for f in (jfirst, jsecond)]
    xt = torch.tensor(x).to(tdt).requires_grad_(True)
    (first,) = torch.autograd.grad(softplus_b(xt), xt, torch.tensor(w).to(tdt))
    (slope,) = torch.autograd.grad(softplus_b(xt).float().sum(), xt,
                                   create_graph=True)
    (second,) = torch.autograd.grad((torch.tensor(w) * slope.float()).sum(),
                                    xt)
    for got, ref in zip((first, second), want):
        got = got.float().numpy()
        if dtype == "bfloat16":
            np.testing.assert_allclose(got, ref, rtol=0, atol=1e-30)
        else:
            np.testing.assert_allclose(got, ref, rtol=0,
                                       atol=2e-6 * np.abs(ref).max())


def test_bf16_spatial_gradient_is_jaxs_program_as_written():
    """The SDF's spatial gradient under the training precision (bf16
    products and activations), the eikonal term's input, at the dtu
    width on 2,048 points from JAX's init at seed 1: the port's
    (`network.sdf_gradient`) against the JAX package's jitted
    `sdf_gradient`, compiled with AS_WRITTEN (XLA's excess precision
    off: a bf16 rounding wherever its jaxpr converts). Mean |grad|
    within 1e-4 (measured 6.0e-6), the eikonal mean((|grad| - 1)^2)
    within 2e-4 relative (4.0e-5), the whole within 3e-3 relative
    (2.0e-3). JAX's default compile keeps some of those roundings in
    float32 and lands 1.3% away on the eikonal value (an intended
    difference, ROADMAP queue 3): pinned as at least ten times the
    as-written gap. With autograd's softplus derivative (the port at
    19839b1) the mean |grad| was 1.5e-3 short of the as-written program's
    and the eikonal 1.5% off."""
    from s_volsdf_tpu.models.network import sdf_gradient
    from s_volsdf_tpu_torch.config import dtu_config
    from s_volsdf_tpu_torch.models import network
    from test_torch_config import params_pair
    jcfg, tcfg = jconfig.dtu_config(), dtu_config()
    jp, tp = params_pair(jcfg, seed=1)
    jm = dataclasses.replace(jcfg.model, compute_dtype="bfloat16",
                             activation_dtype="bfloat16")
    pts = np.random.default_rng(0).uniform(-1.5, 1.5, (2048, 3)
                                           ).astype(np.float32)
    lowered = jax.jit(lambda p, x: sdf_gradient(p, jm, x, 3.0)).lower(
        jp["sdf"], pts)
    written, default = (np.asarray(lowered.compile(opts)(jp["sdf"], pts),
                                   np.float64) for opts in (AS_WRITTEN, None))
    got = network.sdf_gradient(tp.sdf, tts.training_model_config(tcfg),
                               torch.tensor(pts), 3.0).detach().double().numpy()

    def eik(g):
        return float(np.mean((np.linalg.norm(g, axis=1) - 1) ** 2))

    gap = {name: (float(np.mean(np.linalg.norm(got, axis=1)
                                - np.linalg.norm(ref, axis=1))),
                  abs(eik(got) - eik(ref)) / eik(ref),
                  float(np.linalg.norm(got - ref) / np.linalg.norm(ref)))
           for name, ref in (("written", written), ("default", default))}
    print(f"mean |grad|, eikonal, whole: {gap}")
    norm, eik_gap, whole = gap["written"]
    assert abs(norm) <= 1e-4 and eik_gap <= 2e-4 and whole <= 3e-3, gap
    assert gap["default"][1] >= 10 * eik_gap, gap


# --------------------------------------------------------------------------
# The full-width runs (python tests/test_torch_trajectory.py ...)
# --------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["paired", "unpaired", "inits",
                                     "summarize", "gradients", "logits"])
    ap.add_argument("--precision", default="defaults",
                    choices=["defaults", "float32"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--root", default=None, help="the fixture's directory")
    ap.add_argument("--init", default="jax", choices=["jax", "port"],
                    help="paired: whose init at cfg.seed both start from")
    ap.add_argument("--seed", type=int, default=0,
                    help="unpaired: cfg.seed of the JAX package's own loop; "
                         "paired: the stream's seed")
    ap.add_argument("--save-at", type=int, default=None,
                    help="unpaired: save JAX's TrainState after this step "
                         "(a multiple of --chunk) to --state-out")
    ap.add_argument("--state-out", default=None,
                    help="unpaired: the npz --save-at writes")
    ap.add_argument("--from-state", default=None,
                    help="paired, gradients, logits: start from this "
                         "saved JAX TrainState (an npz of --state-out)")
    ap.add_argument("--seeds", type=int, default=20,
                    help="inits: JAX's dtu inits of seeds 0 .. N-1, each an "
                         "npz keyed by the port's parameter names, into "
                         "--out (a directory) for "
                         "`test_torch_trajectory_runs.py inits --jax-inits`")
    ap.add_argument("--chunk", type=int, default=25)
    ap.add_argument("--draws", type=int, default=5,
                    help="gradients: the batches to compare on")
    ap.add_argument("--as-written", action="store_true",
                    help="gradients: compile JAX's program with XLA's "
                         "excess precision off (AS_WRITTEN), so that it "
                         "rounds to bf16 wherever its jaxpr says")
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
    if args.mode in ("gradients", "logits"):
        # each loss term's gradient (or the radiance logits) in both
        # packages at --from-state and at JAX's init, on --draws batches
        # of the stream of --seed
        if args.mode == "gradients":
            res = gradients_at_state(args.precision, args.from_state,
                                     root=root, draws=args.draws,
                                     stream_seed=args.seed,
                                     as_written=args.as_written)
            tag["jax_program"] = "as written" if args.as_written \
                else "default"
        else:
            res = logits_at_state(args.precision, args.from_state, root=root,
                                  draws=args.draws, stream_seed=args.seed)
        with open(args.out, "w") as f:
            json.dump({**tag, "from_state": os.path.basename(
                args.from_state), "bars": GRAD_BARS, "draws": res}, f)
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
                              init=args.init, overrides=args.override,
                              from_state=args.from_state,
                              stream_seed=args.seed)
        tag["overrides"] = args.override
        if args.from_state:
            tag.update(from_state=os.path.basename(args.from_state),
                       stream_seed=args.seed)
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
        if args.save_at is not None and not args.state_out:
            ap.error("--save-at needs --state-out")
        with tempfile.TemporaryDirectory() as tmp:
            rows = unpaired_jax(su, args.seed, args.steps, args.chunk, tmp,
                                save_at=args.save_at,
                                state_out=args.state_out)
        rows = [{**tag, "package": "jax", "device": "cpu",
                 "seed": args.seed, **r} for r in rows]
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"{args.mode} {args.precision}: {time.time() - t0:.0f} s")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    main()
