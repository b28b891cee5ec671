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

The full-width runs under runs_torch/ are driven by
tests/test_torch_trajectory.py (the JAX package's side) and
tests/test_torch_trajectory_runs.py (the port's, without JAX).
"""

from __future__ import annotations

import math
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Sequence

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


def record(step: int, lo, grad_norm: float, beta: float) -> Dict:
    """One step's row: each loss term, the PSNR, beta, the gradient's
    global norm (before the clip) and the guard's flag."""
    row = {"step": step}
    for k in TERMS:
        row[k] = float(getattr(lo, k))
    row.update(beta=beta, grad_norm=grad_norm,
               grad_finite=float(lo.grad_finite))
    return row


def fresh_state(cfg, params):
    """A step-0 TrainState of `params` and its optimizer."""
    from s_volsdf_tpu_torch.engine import train_step as tts
    tx = tts.make_optimizer(cfg, params)
    return tts.init_train_state(cfg, params, tx), tx


def run_port(cfg, state, tx, mvs, batches, device) -> List[Dict]:
    """The port's step (`loss_and_grads`, `guarded_update`) on each
    batch, moved to `device`; a row (`record`) a step."""
    from s_volsdf_tpu_torch.engine.train_step import (guarded_update,
                                                      loss_and_grads)
    from s_volsdf_tpu_torch.models.density import get_beta
    rows = []
    for batch in batches:
        b = to_device(batch, device)
        grads, lo = loss_and_grads(state.params, cfg, b, None, mvs,
                                   state.iter_step)
        norm = math.sqrt(float(sum(torch.sum(g * g) for g in grads)))
        state, lo = guarded_update(tx, state, grads, lo)
        beta = float(get_beta(state.params.density,
                              cfg.model.density.beta_min).detach())
        rows.append(record(state.iter_step, lo, norm, beta))
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
