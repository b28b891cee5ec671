"""Smoke run of the PyTorch port (s_volsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once at the dtu model's full width and
checks it, in phases that print in order:

  1. environment: torch and CUDA versions, the card, its power limit;
  2. build: compiles csrc/fused_sdf.cu with nvcc (seconds printed);
  3. kernel: the fused SDF kernel against its plain PyTorch version on
     65,536 and 700 points (max |diff| <= 1e-4), and both timed;
  4. training: 20 steps of VolTrainer at bench.py's shapes (576x768
     scene, 512 rays/step, three 192x288x384 MVS volumes), float32;
  5. feedback render: render_mvs of view 0 at quarter resolution
     (144x192, fast=-1, chunk 16,384), and a 6x8-pixel render on the card
     against the same render on the CPU's plain path;
  6. a JSON line with the kernel's numbers, the card's name and power
     limit, and the last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a CUDA device. Weights are random,
from seed 0. The matmul and cuDNN TF32 paths are switched off: the
plain version is the float32 reference.

The helpers `float32_dtu_config`, `make_volumes` and `make_trainer` are
shared with the CPU test of the same loop (tests/test_torch_trainer.py).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from s_volsdf_tpu_torch.config import Config, dtu_config
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.synthetic import gt_prob_volume, make_sphere_scene
from s_volsdf_tpu_torch.engine.render import render_depth
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from s_volsdf_tpu_torch.models.network import init_volsdf_params
from s_volsdf_tpu_torch.ops import fused_sdf
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes

KERNEL_TOL = 1e-4     # f32 sums in another order across 9 layers
RENDER_TOL = 2e-4     # the VolSDF render bar (README "Verified parity")
TRAIN_STEPS = 20


def float32_dtu_config() -> Config:
    """The dtu preset with the three training precision knobs at float32
    (the JAX defaults are bf16, which the port refuses)."""
    cfg = dtu_config()
    cfg.train.train_compute_dtype = "float32"
    cfg.train.train_activation_dtype = "float32"
    cfg.train.mvs_pack_dtype = "float32"
    return cfg


def make_volumes(scene, vol_shape, device) -> MVSVolumes:
    """Informative MVS volumes (D, Hc, Wc) for every view, with
    bench.py's arguments (sigma 1 interval, floor 0.02, depth noise
    2.5/200, hypotheses linspace(0.5, 5.0, D))."""
    D, Hc, Wc = vol_shape
    H, W = scene.img_res
    dvals = np.linspace(0.5, 5.0, D).astype(np.float32)
    rng = np.random.default_rng(7)
    probs = []
    for v in range(scene.poses.shape[0]):
        Kc = scene.intrinsics[v].copy()
        Kc[0, :] *= Wc / W
        Kc[1, :] *= Hc / H
        prob, _ = gt_prob_volume(scene.poses[v], Kc, (Hc, Wc), dvals,
                                 scale_factor=1.0, sigma_intervals=1.0,
                                 floor=0.02, depth_noise=2.5 / 200.0, rng=rng)
        probs.append(prob)
    V = len(probs)
    z_slab = np.stack([np.full((V, Hc, Wc), dvals[0], np.float32),
                       np.full((V, Hc, Wc), dvals[-1], np.float32)], axis=1)

    def put(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return MVSVolumes(prob=put(np.stack(probs)), z_slab=put(z_slab),
                      intrinsics=put(scene.intrinsics), c2w=put(scene.poses),
                      img_res=scene.img_res, inverse_depth=False)


def make_trainer(cfg: Config, img_res, vol_shape, device) -> VolTrainer:
    """A VolTrainer on a 3-view sphere scene with informative volumes,
    one step per chunk (so chunk_seconds are step times)."""
    scene = make_sphere_scene(3, img_res)
    trainer = VolTrainer(cfg, scene_from_synthetic(scene), device=device,
                         chunk_steps=1)
    trainer.mvs = make_volumes(scene, vol_shape, device)
    return trainer


def _median_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def main() -> None:
    # 1. Environment.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}", flush=True)
    print(f"[env] card: {card}", flush=True)

    # 2. Build.
    t0 = time.perf_counter()
    fused_sdf.build(force=True)
    print(f"[build] csrc/fused_sdf.cu built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 3. Kernel against its plain version, full dtu width.
    cfg = float32_dtu_config()
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                dev)
    errs = {}
    for n in (65536, 700):
        pts = torch.as_tensor(
            np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32),
            device=dev)
        got = fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0)
        ref = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts, 3.0)
        torch.cuda.synchronize()
        errs[n] = torch.max(torch.abs(got - ref)).item()
        _check(errs[n] <= KERNEL_TOL,
               f"kernel vs plain at {n} points: {errs[n]} > {KERNEL_TOL}")
    pts = torch.as_tensor(
        np.random.default_rng(1).normal(size=(65536, 3)).astype(np.float32),
        device=dev)
    kernel_ms = _median_ms(
        lambda: fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0))
    plain_ms = _median_ms(
        lambda: fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts, 3.0))
    print(f"[kernel] fused_sdf vs plain: max|diff| {errs[65536]:.3e} at "
          f"65536 pts, {errs[700]:.3e} at 700 pts (tol {KERNEL_TOL}); "
          f"median of 20: kernel {kernel_ms:.3f} ms, plain {plain_ms:.3f} ms "
          f"at 65536 pts [{card}]", flush=True)

    # 4. Training at bench.py's shapes.
    t0 = time.perf_counter()
    trainer = make_trainer(cfg, (cfg.max_h, cfg.max_w), (192, 288, 384), dev)
    torch.cuda.synchronize()
    print(f"[train] scene + volumes set up in {time.perf_counter() - t0:.2f} s",
          flush=True)
    fused_sdf.fused_sdf_values.launches = 0     # the main path starts here
    trainer.run(TRAIN_STEPS)
    torch.cuda.synchronize()
    train_launches = fused_sdf.fused_sdf_values.launches
    losses = [lo.loss for lo in trainer.losses]
    finite = [lo.grad_finite for lo in trainer.losses]
    _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
           f"finite losses: {losses}")
    _check(all(f == 1.0 for f in finite), f"grad_finite every step: {finite}")
    _check(train_launches >= TRAIN_STEPS,
           f"kernel launches in training {train_launches} < {TRAIN_STEPS}")
    step_ms = 1e3 * float(np.median(trainer.chunk_seconds))
    print(f"[train] {TRAIN_STEPS} steps: loss {losses[0]:.5f} -> "
          f"{losses[-1]:.5f}, median {step_ms:.2f} ms/step, "
          f"{cfg.train.num_pixels / (step_ms / 1e3):.1f} rays/s, kernel "
          f"launches {train_launches} [{card}]", flush=True)

    # 5. Feedback render of view 0 at quarter resolution.
    t0 = time.perf_counter()
    depth = trainer.render_mvs(0, res_scale=0.25)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = fused_sdf.fused_sdf_values.launches   # the main path ends here
    _check(depth.shape == (144, 192), f"render shape {depth.shape}")
    _check(bool(np.isfinite(depth).all()), "finite depth")
    _check(launches > train_launches,
           f"kernel launches in the render: {launches - train_launches}")
    print(f"[render] render_mvs 144x192 fast=-1 in {render_s:.3f} s, depth "
          f"{depth.min():.4f}..{depth.max():.4f}, kernel launches "
          f"{launches - train_launches} [{card}]", flush=True)

    # The trained field rendered on the card (kernel) and on the CPU
    # (plain path) agree on a small view.
    scene = trainer.scene
    intr = np.array(scene.intrinsics[0], np.float32)
    intr[:2] *= 8 / scene.img_res[1]
    args = (cfg.model, scene.poses[0], intr, (6, 8))
    on_card = render_depth(trainer.state.params, *args, chunk=48)
    cpu_params = init_volsdf_params(torch.Generator().manual_seed(0),
                                    cfg.model, "cpu")
    cpu_params.load_state_dict(trainer.state.params.state_dict())
    on_cpu = render_depth(cpu_params, *args, chunk=48, device="cpu")
    ref_err = max(float(np.max(np.abs(on_card[k] - on_cpu[k])))
                  for k in ("depth", "acc"))
    _check(ref_err <= RENDER_TOL,
           f"6x8 render, card vs CPU plain: {ref_err} > {RENDER_TOL}")
    print(f"[render] 6x8 render card vs CPU plain path: max|diff| "
          f"{ref_err:.3e} (tol {RENDER_TOL})", flush=True)

    # 6. Results.
    print(json.dumps({"kernels": [{
        "name": "fused_sdf",
        "route": "cuda",
        "source": "s_volsdf_tpu_torch/csrc/fused_sdf.cu",
        "replaces": "s_volsdf_tpu/ops/pallas/fused_sdf.py:116",
        "launches": launches,
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
