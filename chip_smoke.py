"""Smoke run of the PyTorch port (s_volsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once at the dtu model's full width and
checks it, in phases that print in order:

  1. environment: torch and CUDA versions, the card, its power limit;
  2. build: compiles csrc/fused_sdf.cu with nvcc (seconds printed);
  3. kernel: the fused SDF kernel against its plain PyTorch version on
     65,536, 700 and 2,097,152 points (one training sweep, a ragged
     tail, one render launch; max |diff| <= 1e-4); the kernel timed at
     65,536 and 2,097,152 points with its TFLOP/s and its share of the
     bound (three bf16 products per multiply-add at 989 TFLOP/s), the
     plain version at 65,536; after phase 5, the kernel again on 65,536
     points of the trained field's own rays nearest its surface;
  4. training: 20 steps of VolTrainer at bench.py's shapes (576x768
     scene, 512 rays/step, three 192x288x384 MVS volumes), float32;
  5. feedback render: render_mvs of view 0 at quarter resolution
     (144x192, fast=-1, chunk 16,384; the weights packed once for it),
     and a 6x8-pixel render on the card against the same render on the
     CPU's plain path;
  6. cascade: `save_scene_depth` on a 576x768 DTU-layout fixture (scan106)
     at x2 MVS resolution (1152x1536), D = 192/32/8, the full casmvsnet
     and dtu VolSDF widths: stage 0, 20 VolSDF steps regularised by its
     volumes, the three 576x768 feedback renders (fused SDF kernel),
     stages 1 and 2 on the fed-back depth, the PFMs and cam files; the
     three stages of the run's first view recomputed on the CPU from the
     same inputs and bridged weights, against the card's; then the three
     stages of one view at 64x96 on the card against the CPU. Prints
     each stage's seconds and peak memory, the render seconds per view,
     the step median;
  7. a JSON line with the kernel's numbers, the card's name and power
     limit, and the last line {"ok": true, "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a CUDA device. Weights are random,
from seed 0. The matmul and cuDNN TF32 paths are switched off: the
plain version is the float32 reference.

The helpers `float32_dtu_config`, `make_volumes` and `make_trainer` are
shared with the CPU test of the same loop (tests/test_torch_trainer.py),
`cascade_config` and `cascade_card_vs_cpu` with tests/test_torch_cuda.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from s_volsdf_tpu_torch.bridge import from_jax_mvs_params, to_jax_mvs_params
from s_volsdf_tpu_torch.config import Config, dtu_config
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.data.io import read_pfm
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.splits import get_trains_ids
from s_volsdf_tpu_torch.data.synthetic import gt_prob_volume, make_sphere_scene
from s_volsdf_tpu_torch.engine.render import render_depth
from s_volsdf_tpu_torch.engine.runner import MVSEngine, save_scene_depth
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from s_volsdf_tpu_torch.models.network import init_volsdf_params, render_rays
from s_volsdf_tpu_torch.ops import fused_sdf
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes

# The kernel's bf16 x 3 split (about 2^-16 of each product) and f32 sums
# in another order across 9 layers.
KERNEL_TOL = 1e-4
KERNEL_SWEEP, KERNEL_RENDER = 65536, 2097152   # one step's sweep, one render launch
BF16_TFLOPS = 989.0   # the H100's dense bf16 tensor-core peak
RENDER_TOL = 2e-4     # the VolSDF render bar (README "Verified parity")
TRAIN_STEPS = 20
CASCADE_RES = (576, 768)            # the dtu images
CASCADE_X2, CASCADE_MVS_RES = True, (1152, 1536)   # x2_mvsres
CASCADE_NDEPTHS = (192, 32, 8)
SMALL_RES, SMALL_NDEPTHS = (64, 96), (16, 8, 8)
PROB_SUM_TOL = 1e-4   # every prob_volume sums to 1 along depth
# Card against CPU: cuDNN's float32 convs sum in another order than the
# CPU's, through the 3D UNet and a softmax.
PROB_TOL = 1e-4
DEPTH_RTOL = 1e-5
SCAN = "scan106"


def float32_dtu_config() -> Config:
    """The dtu preset with the three training precision knobs and the
    cascade's at float32 (the JAX defaults are bf16, which the port
    refuses)."""
    cfg = dtu_config()
    cfg.train.train_compute_dtype = "float32"
    cfg.train.train_activation_dtype = "float32"
    cfg.train.mvs_pack_dtype = "float32"
    cfg.mvs.compute_dtype = "float32"
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


def cascade_config(data_root: str, img_res, ndepths, x2_mvsres: bool,
                   opt_stepNs) -> Config:
    """The float32 dtu preset reading the DTU-layout fixture under
    data_root at img_res, with the cascade's hypothesis counts."""
    cfg = float32_dtu_config()
    cfg.data_dir_root = cfg.dataset.data_dir_root = data_root
    cfg.max_h, cfg.max_w = img_res
    cfg.dataset.img_res = tuple(img_res)
    cfg.mvs.ndepths, cfg.mvs.numdepth = tuple(ndepths), ndepths[0]
    cfg.mvs.x2_mvsres = x2_mvsres
    cfg.mvs.interval_scale = 1.06
    cfg.opt_stepNs = tuple(opt_stepNs)
    return cfg


def stages_against_cpu(card: MVSEngine, sample, card_outs) -> Dict[str, float]:
    """Recompute the three cascade stages of one MVS sample on the CPU,
    with the card engine's weights (through the bridge), from the inputs
    the card's stages had: the sample's images, and for stages 1 and 2
    the depth the card's previous stage handed on (`card_outs[k - 1]
    ["depth"]`, on the host; after a stage with an optimisation budget,
    the VolSDF feedback render). The CPU computes its own features.
    Returns the largest |prob_volume| difference and the largest relative
    difference of the regressed depth sum(prob * hypotheses) over the
    stages, and the CPU's seconds."""
    cfg = card.cfg
    cpu = MVSEngine(cfg, device="cpu")
    cpu.net = from_jax_mvs_params(to_jax_mvs_params(card.net),
                                  cfg.mvs.ndepths, cfg.mvs.cr_base_chs,
                                  device="cpu")
    t0 = time.perf_counter()
    feats = cpu.scene_feature_cache(sample.imgs)["feats"]
    hw = sample.imgs.shape[1:3]
    prob_err = depth_err = 0.0
    for stage, got in enumerate(card_outs):
        want = cpu.stage(stage, feats,
                         sample.proj_matrices[f"stage{stage + 1}"],
                         sample.depth_values,
                         None if stage == 0 else card_outs[stage - 1]["depth"],
                         hw, inverse_depth=cfg.inverse_depth and stage == 0)
        pv, dv = got["prob_volume"].cpu(), got["depth_values"].cpu()
        prob_err = max(prob_err,
                       (pv - want["prob_volume"]).abs().max().item())
        want_depth = (want["prob_volume"] * want["depth_values"]).sum(0)
        depth_err = max(depth_err, ((pv * dv).sum(0) - want_depth).abs()
                        .div(want_depth.abs()).max().item())
        del want, pv, dv
    return {"prob": prob_err, "depth_rel": depth_err,
            "cpu_s": time.perf_counter() - t0}


def cascade_card_vs_cpu(device, data_root: str) -> Dict[str, float]:
    """The three cascade stages of the first reference view of a 64x96
    fixture (written under data_root if absent), x2_mvsres off, D =
    16/8/8, chained on `device`, then held against the CPU
    (`stages_against_cpu`)."""
    if not os.path.isdir(os.path.join(data_root, "DTU")):
        make_dtu_fixture(data_root, img_res=SMALL_RES)
    cfg = cascade_config(data_root, SMALL_RES, SMALL_NDEPTHS, False,
                         (0, 0, 0))
    sample = MVSDataset(
        datapath=os.path.join(data_root, "DTU", "mvs_data"), scan=SCAN,
        nviews=cfg.num_view, data_dir="DTU", ndepths=cfg.mvs.numdepth,
        interval_scale=cfg.mvs.interval_scale, max_h=cfg.max_h,
        max_w=cfg.max_w, trains_i=get_trains_ids("DTU", SCAN, cfg.num_view),
        data_dir_root=data_root, x2_mvsres=False)[0]
    card = MVSEngine(cfg, device=device)
    feats = card.scene_feature_cache(sample.imgs)["feats"]
    outs, prev = [], None
    for stage in range(3):
        out = card.stage(stage, feats, sample.proj_matrices[f"stage{stage + 1}"],
                         sample.depth_values, prev, sample.imgs.shape[1:3],
                         inverse_depth=False)
        prev = out["depth"] = out["depth"].cpu().numpy()
        outs.append(out)
    return stages_against_cpu(card, sample, outs)


def _check_stage(out: Dict, stage: int, shape) -> None:
    """A stage's volumes have the stage's shape, sum to 1 along depth,
    and regress a finite depth inside the pixel's hypothesis range. A
    softmax over depth implies the last two wherever it is finite, so
    this guards shapes and NaNs; `stages_against_cpu` is the check of
    the values."""
    pv, dv = out["prob_volume"], out["depth_values"]
    _check(tuple(pv.shape) == tuple(dv.shape) == tuple(shape),
           f"stage {stage}: prob {tuple(pv.shape)} depth_values "
           f"{tuple(dv.shape)}, want {shape}")
    err = (pv.sum(0) - 1.0).abs().max().item()
    _check(err <= PROB_SUM_TOL, f"stage {stage}: prob sums off by {err}")
    # Stage 0's own depth is overwritten by the feedback render: take the
    # regression again from its volumes.
    depth = (pv * dv).sum(0)
    lo, hi = dv.min(0).values, dv.max(0).values
    slack = 1e-5 * hi.abs().max()
    _check(bool(torch.isfinite(depth).all()), f"stage {stage}: finite depth")
    _check(bool(((depth >= lo - slack) & (depth <= hi + slack)).all()),
           f"stage {stage}: depth outside the hypothesis range")


def run_cascade(dev, card: str, tmp: str) -> int:
    """Phase 6's full-width run (see the module docstring); returns the
    fused SDF kernel's launches in it."""
    data_root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    make_dtu_fixture(data_root, img_res=CASCADE_RES)
    print(f"[cascade] {CASCADE_RES[0]}x{CASCADE_RES[1]} DTU fixture written "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    cfg = cascade_config(data_root, CASCADE_RES, CASCADE_NDEPTHS, CASCADE_X2,
                         (TRAIN_STEPS, 0, 0))
    engine = MVSEngine(cfg, device=dev)
    fused_sdf.fused_sdf_values.launches = 0     # the cascade path starts
    t0 = time.perf_counter()
    res = save_scene_depth(cfg, SCAN, exps_root=tmp, engine=engine)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = fused_sdf.fused_sdf_values.launches   # ... and ends here
    trainer = res["trainer"]

    losses = [lo.loss for lo in trainer.losses]
    _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
           f"cascade: finite losses: {losses}")
    _check(len(res["feedback_launches"]) == 3
           and all(n > 0 for n in res["feedback_launches"]),
           f"fused SDF launches per feedback render: "
           f"{res['feedback_launches']}")
    H2, W2 = CASCADE_MVS_RES
    for out in res["outs"]:
        for stage, scale in enumerate((4, 2, 1)):
            _check_stage(out[f"stage{stage + 1}"], stage,
                         (CASCADE_NDEPTHS[stage], H2 // scale, W2 // scale))
    for vid in trainer.trains_i:
        for kind, suffix in (("depth_est", ".pfm"), ("confidence", ".pfm"),
                             ("cams", "_cam.txt")):
            path = os.path.join(res["outdir"], SCAN, kind,
                                f"{vid:08d}{suffix}")
            _check(os.path.isfile(path), f"missing {path}")
            if suffix == ".pfm":
                arr, _ = read_pfm(path)
                _check(arr.shape == (H2, W2) and np.isfinite(arr).all(),
                       f"{path}: shape {arr.shape}, finite "
                       f"{np.isfinite(arr).all()}")

    print(f"[cascade] save_scene_depth {SCAN}, MVS {H2}x{W2}, D "
          f"{'/'.join(map(str, CASCADE_NDEPTHS))}, {TRAIN_STEPS} steps: "
          f"{total_s:.2f} s [{card}]", flush=True)
    for stage, (s, peak) in enumerate(zip(res["stage_seconds"],
                                          res["stage_peak_bytes"])):
        print(f"[cascade] stage {stage}: {s:.3f} s for 3 views, peak "
              f"allocated {peak / 2**30:.2f} GiB [{card}]", flush=True)
    step_ms = 1e3 * float(np.median(trainer.step_seconds))
    mvs_losses = [lo.mvs_loss for lo in trainer.losses]
    print(f"[cascade] {TRAIN_STEPS} steps on stage 0's volumes: loss "
          f"{losses[0]:.5f} -> {losses[-1]:.5f}, mvs loss {mvs_losses[0]:.5f}"
          f" -> {mvs_losses[-1]:.5f}, median {step_ms:.2f} ms/step [{card}]",
          flush=True)
    print(f"[cascade] feedback renders {CASCADE_RES[0]}x{CASCADE_RES[1]}: "
          + ", ".join(f"{s:.3f} s" for s in res["feedback_seconds"])
          + f"; fused SDF launches {res['feedback_launches']} [{card}]",
          flush=True)

    # The main path's own stages of the first view, at full width,
    # against the CPU.
    errs = stages_against_cpu(engine, res["samples"][0],
                              [res["outs"][0][f"stage{k + 1}"]
                               for k in range(3)])
    _check(errs["prob"] <= PROB_TOL and errs["depth_rel"] <= DEPTH_RTOL,
           f"full-width cascade card vs CPU: {errs} (tol prob {PROB_TOL}, "
           f"depth rel {DEPTH_RTOL})")
    print(f"[cascade] 3 stages of view {res['samples'][0].view_ids[0]} at "
          f"{H2}x{W2}, D "
          f"{'/'.join(map(str, CASCADE_NDEPTHS))}, card vs CPU: prob "
          f"max|diff| {errs['prob']:.3e} (tol {PROB_TOL}), depth max rel "
          f"diff {errs['depth_rel']:.3e} (tol {DEPTH_RTOL}); CPU "
          f"{errs['cpu_s']:.2f} s", flush=True)

    errs = cascade_card_vs_cpu(dev, os.path.join(tmp, "small"))
    _check(errs["prob"] <= PROB_TOL and errs["depth_rel"] <= DEPTH_RTOL,
           f"cascade card vs CPU: {errs} (tol prob {PROB_TOL}, depth "
           f"rel {DEPTH_RTOL})")
    print(f"[cascade] 3 stages at {SMALL_RES[0]}x{SMALL_RES[1]}, D "
          f"{'/'.join(map(str, SMALL_NDEPTHS))}, card vs CPU: prob max|diff| "
          f"{errs['prob']:.3e} (tol {PROB_TOL}), depth max rel diff "
          f"{errs['depth_rel']:.3e} (tol {DEPTH_RTOL})", flush=True)
    return launches


def sdf_flops_per_point(sdf_params) -> int:
    """2 x the multiply-adds of one point through the SDF MLP: every
    layer with its input width padded to 4, the last one for its SDF
    column only (459,264 multiply-adds at the dtu width)."""
    wb = fused_sdf.normalized_weights(sdf_params)
    return 2 * sum(-(-w.shape[0] // 4) * 4 * (w.shape[1] if l < len(wb) - 1
                                              else 1)
                   for l, (w, _) in enumerate(wb))


def near_surface_points(trainer, n_rays: int = 2048, keep: int = 65536):
    """The sampler's final samples on n_rays random pixels of view 0
    (render_rays, eval, fast=-1), the `keep` of them nearest the trained
    field's surface by the plain SDF; and the largest |sdf| kept."""
    cfg, scene, dev = trainer.cfg.model, trainer.scene, trainer.device
    H, W = scene.img_res
    pix = np.random.default_rng(3).integers(0, H * W, n_rays)
    uv = torch.as_tensor(np.stack([pix % W, pix // W], -1)[None]
                         .astype(np.float32), device=dev)
    pose = torch.as_tensor(scene.poses[:1], dtype=torch.float32, device=dev)
    intr = torch.as_tensor(scene.intrinsics[:1], dtype=torch.float32,
                           device=dev)
    params = trainer.state.params
    with torch.no_grad():
        out = render_rays(params, cfg, uv, pose, intr,
                          torch.Generator(device=dev).manual_seed(0),
                          training=False, fast=-1)
    xyz = out.xyz.detach().reshape(-1, 3).contiguous()
    sdf = fused_sdf.sdf_values_plain(params.sdf, cfg, xyz,
                                     cfg.scene_bounding_sphere).abs()
    idx = torch.argsort(sdf)[:keep]
    return xyz[idx].contiguous(), sdf[idx].max().item()


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
    for n in (KERNEL_SWEEP, 700, KERNEL_RENDER):
        pts = torch.as_tensor(
            np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32),
            device=dev)
        got = fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0)
        ref = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts, 3.0)
        torch.cuda.synchronize()
        errs[n] = torch.max(torch.abs(got - ref)).item()
        _check(errs[n] <= KERNEL_TOL,
               f"kernel vs plain at {n} points: {errs[n]} > {KERNEL_TOL}")
        del got, ref
    t0 = time.perf_counter()
    pack = fused_sdf.pack_sdf(params.sdf, cfg.model)
    torch.cuda.synchronize()
    pack_ms = 1e3 * (time.perf_counter() - t0)
    flop = sdf_flops_per_point(params.sdf)
    kernel_ms, bound_ms = {}, {}
    for n in (KERNEL_SWEEP, KERNEL_RENDER):
        pts = torch.as_tensor(
            np.random.default_rng(1).normal(size=(n, 3)).astype(np.float32),
            device=dev)
        kernel_ms[n] = _median_ms(lambda: fused_sdf.fused_sdf_values(
            params.sdf, cfg.model, pts, 3.0, pack=pack))
        bound_ms[n] = 3 * n * flop / (BF16_TFLOPS * 1e12) * 1e3
        if n == KERNEL_SWEEP:
            plain_ms = _median_ms(lambda: fused_sdf.sdf_values_plain(
                params.sdf, cfg.model, pts, 3.0))
    tflops = {n: n * flop / (ms * 1e-3) / 1e12 for n, ms in kernel_ms.items()}
    print(f"[kernel] fused_sdf vs plain: max|diff| {errs[KERNEL_SWEEP]:.3e} "
          f"at {KERNEL_SWEEP} pts, {errs[700]:.3e} at 700 pts, "
          f"{errs[KERNEL_RENDER]:.3e} at {KERNEL_RENDER} pts (tol "
          f"{KERNEL_TOL}) [{card}]", flush=True)
    for n in (KERNEL_SWEEP, KERNEL_RENDER):
        print(f"[kernel] {n} pts: kernel {kernel_ms[n]:.4f} ms (median of "
              f"20), {tflops[n]:.1f} TFLOP/s, bound {bound_ms[n]:.4f} ms "
              f"(3 bf16 products at {BF16_TFLOPS:.0f} TFLOP/s): "
              f"{100 * bound_ms[n] / kernel_ms[n]:.1f}% of bound"
              + (f"; plain {plain_ms:.3f} ms" if n == KERNEL_SWEEP else "")
              + f" [{card}]", flush=True)
    print(f"[kernel] pack_sdf (weight norm, split, layout) {pack_ms:.2f} ms "
          f"[{card}]", flush=True)
    del pack

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
    builds = fused_sdf.pack_sdf.builds
    depth = trainer.render_mvs(0, res_scale=0.25)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    launches = fused_sdf.fused_sdf_values.launches   # the main path ends here
    _check(fused_sdf.pack_sdf.builds == builds + 1,
           f"packs built in one render: {fused_sdf.pack_sdf.builds - builds}")
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

    # 3, continued: the kernel on the trained field's own rays, nearest
    # its surface, where the sampler's choices are most sensitive.
    near, near_sdf = near_surface_points(trainer)
    bs = cfg.model.scene_bounding_sphere
    got = fused_sdf.fused_sdf_values(trainer.state.params.sdf, cfg.model,
                                     near, bs)
    ref = fused_sdf.sdf_values_plain(trainer.state.params.sdf, cfg.model,
                                     near, bs)
    torch.cuda.synchronize()
    errs["near_surface"] = torch.max(torch.abs(got - ref)).item()
    _check(errs["near_surface"] <= KERNEL_TOL,
           f"kernel vs plain near the trained surface: "
           f"{errs['near_surface']} > {KERNEL_TOL}")
    print(f"[kernel] trained field, {near.shape[0]} sampler points of view 0 "
          f"with |sdf| <= {near_sdf:.3e}: kernel vs plain max|diff| "
          f"{errs['near_surface']:.3e} (tol {KERNEL_TOL})", flush=True)
    del trainer, near, got, ref

    # 6. The cascade and the scene runner.
    with tempfile.TemporaryDirectory() as tmp:
        cascade_launches = run_cascade(dev, card, tmp)
    print(f"[cascade] fused SDF launches: {launches} on the training and "
          f"render path, {cascade_launches} on the cascade path", flush=True)

    # 7. Results.
    print(json.dumps({"kernels": [{
        "name": "fused_sdf",
        "route": "cuda",
        "source": "s_volsdf_tpu_torch/csrc/fused_sdf.cu",
        "replaces": "s_volsdf_tpu/ops/pallas/fused_sdf.py:116",
        "launches": launches + cascade_launches,
        "max_abs_err": max(errs.values()),
        "ms": kernel_ms[KERNEL_SWEEP],
        "plain_ms": plain_ms,
        "bound_ms": bound_ms[KERNEL_SWEEP],
        "bound_by": "operations",
        "library_ms": None,
        "tflops": tflops[KERNEL_SWEEP],
        f"ms_at_{KERNEL_RENDER}": kernel_ms[KERNEL_RENDER],
        f"bound_ms_at_{KERNEL_RENDER}": bound_ms[KERNEL_RENDER],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
