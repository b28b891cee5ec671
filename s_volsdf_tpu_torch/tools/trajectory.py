"""Paired training trajectories: the port's step on a stream of draws
that another run consumes too (the JAX package's step in
tests/test_torch_trajectory.py, or the port on another device in
chip_smoke.py's phase 16), with every loss term, the PSNR, beta and the
gradient's global norm recorded at every step.

The scene is a DTU fixture (`make_dtu_fixture`, scan106) under a root
directory, written on the first run; stage 0's volumes are the GT prior
of `tools.run_100k` (`gt_prior`: Gaussian bumps around the analytic
sphere's depth, `np.random.default_rng(7)`). The stream's draws are the
port's own (`engine.train_step.draw_step_inputs`: the view, the pixels
and the jitter feed of the sampler and the eikonal points) from a CPU
generator of one seed, so every device and package that replays it
renders the same rays with the same noise. The parameters are the
port's init at `cfg.seed` unless a caller passes others.

A run's rows at multiples of 50 steps (and step 1) may also hold the
radiance MLP's state over a batch (`colour_diagnostics`, which the
scripts that write the committed runs ask `run_port` for): the share of each
hidden layer's ReLU units that are zero, each channel's share of
sigmoid outputs above 0.99 or below 0.01, and the mean rendered RGB.
A run may start from a saved state instead of an init
(`utils.checkpoint.read_named_state`: the JAX package's TrainState, its
Adam moments and counts included, written by
tests/test_torch_trajectory.py with `--save-at N --state-out X.npz`).

The full-width runs under runs_torch/ are driven by
tests/test_torch_trajectory.py (the JAX package's side) and
tests/test_torch_trajectory_runs.py (the port's, without JAX).
"""

from __future__ import annotations

import contextlib
import math
import os
import tempfile
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

FIXTURE_RES = (192, 256)
TERMS = ("loss", "rgb_loss", "eikonal_loss", "mvs_loss", "sparse_loss",
         "psnr")
# The bars two runs of one stream are held to, step by step
# (tests/test_torch_trajectory.py over 40 steps at the small size;
# chip_smoke.py phase 16 over 10 at full width, on the terms a gate flip
# does not jump): each loss term's difference relative to the larger of
# the two, the PSNR's in dB. Measured worst over the first 10 steps
# (PERF.md §6, PR 15): float32 3e-5 and 1.1e-4 dB; the defaults, where
# bf16 roundings move with the sums' order, from the port's init on the
# CPU and the card 5.9e-3 the total, 1.9e-6 the RGB term, 2.1e-2 the
# eikonal term, 2.4e-3 the MVS term, 9.8e-3 the sparse term, 0.019 dB;
# from the JAX package's seed-0 init 1.0e-2, 5.6e-2, 1.2e-2, 5.2e-3,
# 1.9e-2 and 0.25 dB: there one gated ray's confidence crosses 1e-8 on
# one device and not the other (the RGB term parts at step 8, the PSNR
# at 6), so the RGB and PSNR bars hold the small CPU test, not a full-
# width pair of devices.
BARS = {
    "float32": {"loss": 3e-4, "rgb_loss": 3e-4, "eikonal_loss": 3e-4,
                "mvs_loss": 3e-4, "sparse_loss": 3e-4, "psnr": 0.003},
    "defaults": {"loss": 2e-2, "rgb_loss": 3e-2, "eikonal_loss": 6e-2,
                 "mvs_loss": 2e-2, "sparse_loss": 3e-2, "psnr": 0.2},
}
# The stream seed of the batch that the own-loop runs' rows are
# diagnosed on (`colour_diagnostics`), in both packages.
PROBE_SEED = 1000
# A row's RGB L1 and PSNR on the post-anneal colour plateau of the JAX
# package's runs (both TPU runs and its CPU loop at seed 2); the escape
# is the first row past the anneal under ESCAPE_RGB.
PLATEAU_RGB = (0.060, 0.070)
PLATEAU_PSNR = (22.0, 24.0)
ESCAPE_RGB = 0.05
FLOAT32 = ["train.train_compute_dtype=float32",
           "train.train_activation_dtype=float32",
           "train.mvs_pack_dtype=float32", "mvs.compute_dtype=float32"]


def precision_overrides(precision: str) -> List[str]:
    """Config overrides of a precision name: "defaults" (the JAX
    package's: bf16 products and activations in training, bf16 volumes)
    or "float32"."""
    if precision not in ("defaults", "float32"):
        raise ValueError(f"precision {precision!r}: defaults or float32")
    return [] if precision == "defaults" else list(FLOAT32)


class _PriorArgs:
    """`tools.run_100k`'s GT-prior defaults."""
    prior_sigma, prior_floor, prior_noise = 1.5, 0.05, 2.5


def setup(root: str, *, overrides: Sequence[str] = (), device="cpu"
          ) -> Dict:
    """The fixture's scene, its trainer on `device` (no run directory)
    and its GT-prior volumes: {"cfg", "overrides" (the fixture's and
    `overrides`, which made cfg), "trainer", "outs" (stage 0's
    prob_volume and depth_values per training view, on the device),
    "mvs" (`pack_for_chunk`'s volumes), "scene_cpu" (the training views'
    tensors on the CPU, which the stream draws from)}."""
    from s_volsdf_tpu_torch.config import load_config, per_scene_overrides
    from s_volsdf_tpu_torch.engine.runner import setup_scene
    from s_volsdf_tpu_torch.engine.train_step import pack_for_chunk
    from s_volsdf_tpu_torch.tools.run_100k import gt_prior, scene_setup

    data = os.path.join(root, "data")
    name, ovs = scene_setup("dtu", data, FIXTURE_RES, False)
    ovs += list(overrides)
    cfg = per_scene_overrides(load_config("dtu", overrides=ovs), name)
    with tempfile.TemporaryDirectory() as tmp:
        sc = setup_scene(cfg, name, exps_root=tmp, device=device)
    trainer = sc["trainer"]
    outs = gt_prior(cfg, trainer, sc["samples"], _PriorArgs)
    trainer.stg = 0
    mvs = pack_for_chunk(cfg, trainer.get_mvs_input(outs))
    scene_cpu = {k: v.cpu() for k, v in trainer.scene_tensors().items()}
    return {"cfg": cfg, "overrides": ovs, "trainer": trainer, "outs": outs,
            "mvs": mvs, "scene_cpu": scene_cpu}


def stream(cfg, scene_cpu: Dict, n_steps: int, seed: int
           ) -> Iterator[Dict]:
    """n_steps batches of the serial step's draws (`draw_step_inputs`),
    on the CPU, from one generator seeded with `seed`."""
    from s_volsdf_tpu_torch.engine.train_step import draw_step_inputs
    gen = torch.Generator().manual_seed(seed)
    for _ in range(n_steps):
        yield draw_step_inputs(scene_cpu, gen, cfg=cfg,
                               n_views=scene_cpu["rgb"].shape[0],
                               img_res=tuple(cfg.dataset.img_res),
                               n_rays=cfg.train.num_pixels)


def to_device(batch: Dict, device) -> Dict:
    """A batch (with its jitter feed) on `device`."""
    return {k: to_device(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in batch.items()}


def record(step: int, lo, grad_norm: float, beta: float,
           diagnostics: Optional[Dict] = None) -> Dict:
    """One step's row: each loss term, the PSNR, beta, the gradient's
    global norm (before the clip), the guard's flag and, if given, the
    colour diagnostics (`colour_fields`)."""
    row = {"step": step}
    for k in TERMS:
        row[k] = float(getattr(lo, k))
    row.update(beta=beta, grad_norm=grad_norm,
               grad_finite=float(lo.grad_finite), **(diagnostics or {}))
    return row


def diagnosed(step: int) -> bool:
    """Whether a run's row of `step` holds the colour diagnostics: the
    rows the JSONL files keep (`every(rows, 50)`)."""
    return step == 1 or step % 50 == 0


@contextlib.contextmanager
def rgb_probe(module, zero_share: Callable):
    """Within the block, `module.rgb_mlp` (either package's radiance MLP,
    called as (params, cfg, points, normals, view_dirs, feats)) appends
    to the list it yields, at each call, (the share of each hidden
    layer's ReLU units that are zero, the sigmoid's outputs). A layer's
    share is `zero_share` of the MLP cut after that layer: its sigmoid is
    at most 1/2 exactly where that ReLU's input is at most 0."""
    orig = module.rgb_mlp
    calls = []

    def probed(params, cfg, *inputs):
        out = orig(params, cfg, *inputs)
        calls.append(([zero_share(orig(params[:l + 1], cfg, *inputs))
                       for l in range(len(params) - 1)], out))
        return out

    module.rgb_mlp = probed
    try:
        yield calls
    finally:
        module.rgb_mlp = orig


def colour_fields(zero_shares, sigmoid, rgb_values) -> Dict:
    """A row's colour diagnostics from host arrays: "relu_zero" (a share
    a hidden layer), "sigmoid_saturated" (a channel's share of sigmoid
    outputs above 0.99 or below 0.01), "rgb_mean" (a channel's mean of
    the rendered colour)."""
    sig = np.asarray(sigmoid, np.float32).reshape(-1, 3)
    rgb = np.asarray(rgb_values, np.float32).reshape(-1, 3)
    return {"relu_zero": [float(z) for z in zero_shares],
            "sigmoid_saturated": [float(x) for x in np.mean(
                (sig > 0.99) | (sig < 0.01), axis=0)],
            "rgb_mean": [float(x) for x in rgb.mean(axis=0)]}


def colour_diagnostics(params, cfg, batch: Dict, device) -> Dict:
    """`colour_fields` of the port's training render of `batch` (its
    jitter feed) at `params`, under the training precision."""
    from s_volsdf_tpu_torch.engine.train_step import training_model_config
    from s_volsdf_tpu_torch.models import network
    b = to_device(batch, device)
    with rgb_probe(network, lambda s: float(
            (s <= 0.5).float().mean())) as calls:
        out = network.render_rays(params, training_model_config(cfg),
                                  b["uv"], b["pose"], b["intrinsics"], None,
                                  training=True, fast=1, jitter=b["jitter"])
    zeros, sig = calls[-1]
    return colour_fields(zeros, sig.detach().float().cpu().numpy(),
                         out.rgb_values.detach().float().cpu().numpy())


def probe_batch(cfg, scene_cpu: Dict) -> Dict:
    """The batch the own-loop runs' rows are diagnosed on."""
    return next(stream(cfg, scene_cpu, 1, PROBE_SEED))


def on_plateau(row: Dict) -> bool:
    """Whether a row reads the post-anneal colour plateau: RGB L1 within
    `PLATEAU_RGB` and PSNR within `PLATEAU_PSNR`, both its step's."""
    return (PLATEAU_RGB[0] <= row["rgb_loss"] <= PLATEAU_RGB[1]
            and PLATEAU_PSNR[0] <= row["psnr"] <= PLATEAU_PSNR[1])


def escape_step(rows: List[Dict], anneal: int) -> Optional[int]:
    """The first row's step past `anneal` whose RGB L1 is under
    `ESCAPE_RGB`, or None."""
    for r in rows:
        if r["step"] > anneal and r["rgb_loss"] < ESCAPE_RGB:
            return r["step"]
    return None


def fresh_state(cfg, params):
    """A step-0 TrainState of `params` and its optimizer."""
    from s_volsdf_tpu_torch.engine import train_step as tts
    tx = tts.make_optimizer(cfg, params)
    return tts.init_train_state(cfg, params, tx), tx


def run_port(cfg, state, tx, mvs, batches, device,
             diagnose: Optional[Callable] = None) -> List[Dict]:
    """The port's step (`loss_and_grads`, `guarded_update`) on each
    batch, moved to `device`; a row (`record`) a step. With `diagnose`,
    the `diagnosed` rows also hold diagnose(params, batch): of the step's
    batch (on `device`) at the parameters its loss was taken at."""
    from s_volsdf_tpu_torch.engine.train_step import (guarded_update,
                                                      loss_and_grads)
    from s_volsdf_tpu_torch.models.density import get_beta
    rows = []
    for batch in batches:
        b = to_device(batch, device)
        diag = (diagnose(state.params, b) if diagnose is not None
                and diagnosed(state.iter_step + 1) else None)
        grads, lo = loss_and_grads(state.params, cfg, b, None, mvs,
                                   state.iter_step)
        norm = math.sqrt(float(sum(torch.sum(g * g) for g in grads)))
        state, lo = guarded_update(tx, state, grads, lo)
        beta = float(get_beta(state.params.density,
                              cfg.model.density.beta_min).detach())
        rows.append(record(state.iter_step, lo, norm, beta, diag))
    return rows


def parted(rows_a: List[Dict], rows_b: List[Dict], bars: Dict[str, float]
           ) -> Dict[str, Optional[int]]:
    """For each term of `bars`, the first step at which the two runs'
    values differ by more than the bar (relative to the larger of the
    two magnitudes; the PSNR's bar in dB), or None."""
    out = {}
    for k, bar in bars.items():
        out[k] = None
        for a, b in zip(rows_a, rows_b):
            if diff(k, a[k], b[k]) > bar:
                out[k] = a["step"]
                break
    return out


def diff(term: str, a: float, b: float) -> float:
    """|a - b| in dB for the PSNR, else relative to max(|a|, |b|) (0 when
    both are 0)."""
    if term == "psnr":
        return abs(a - b)
    scale = max(abs(a), abs(b))
    return abs(a - b) / scale if scale > 0 else 0.0
