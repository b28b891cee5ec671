"""Smoke run of the PyTorch port (s_volsdf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once at the dtu model's full width and
checks it, in phases that print in order:

  1. environment: torch and CUDA versions, the card, its power limit;
  2. build: compiles csrc/fused_sdf.cu, csrc/cost_mapping.cu,
     csrc/fusion.cu and csrc/deform_conv.cu with nvcc and
     csrc/downsample.cpp and csrc/mc.cpp with g++, all at once (seconds
     printed);
  3. kernels: the fused SDF kernel against its plain PyTorch version on
     65,536, 700 and 2,097,152 points (one training sweep, a ragged
     tail, one render launch) in both modes: float32 (bf16 x 3 split,
     max |diff| <= 1e-4) and bfloat16 (the training default: one bf16
     product per layer, bf16 activations; within 2^-7 (|sdf| + 1) of
     its plain bf16 version, and from 65,536 points on within
     BF16_KERNEL_MEAN (|sdf| + 1) of it on average; its activation,
     through the kernel's own entry point, equal to torch's bf16
     softplus on the card on every bf16 input, `check_act_bf16`); each
     mode timed at 65,536 and 2,097,152
     points with its TFLOP/s and its share of the bound (three bf16
     products, or one, per multiply-add at 989 TFLOP/s), the plain
     versions at 65,536; the cost-mapping kernel against its plain
     version at bench.py's shapes (512 rays x 96 samples, three
     192x288x384 volumes, float32 and bf16, linear and inverse depth;
     masks equal, pi/pj bit-equal), the making of its corner-block
     copy of the volumes (`check_volumes`), timed cold (20 sample sets,
     each behind a queued device sleep and a 256 MB scratch write, so
     that its sectors come from device memory, as in a training step)
     and warm (one set 20 times, in L2), its wrapper (host and device),
     against its bytes bound (the distinct 32-byte sectors its samples
     read in the corner-block layout it reads, with the unpacked
     volumes' beside it) and the plain version; after phase 5, the
     fused kernel again on 65,536 points of the trained field's own
     rays nearest its surface, in both modes; the deformable-conv
     kernel (9(a));
  4. training: 20 steps of VolTrainer at bench.py's shapes (576x768
     scene, 512 rays/step, three 192x288x384 MVS volumes) at the JAX
     defaults (bf16 products and activations in the training render,
     bf16 volumes), then 20 in float32; both medians, the launches of
     each fused-SDF mode and of the cost-mapping kernel; then, on the
     same scene and volumes, 3 steps and a 6x8 render with each SDF MLP
     outside the fused kernel's family (skips at 2 and 4; width 320),
     whose sweeps take the plain route: no fused-SDF launch, no pack;
  5. feedback render: render_mvs of view 0 at 576x768 (fast=-1, chunk
     16,384; the weights packed once per render) with
     feedback_render_dtype float32 and bfloat16, and a 6x8-pixel render
     on the card against the same render on the CPU's plain path;
  6. cascade: `save_scene_depth` on a 576x768 DTU-layout fixture (scan106)
     at x2 MVS resolution (1152x1536), D = 192/32/8, the full casmvsnet
     (its random convs at He's gain, `he_gain`) and dtu VolSDF widths,
     float32: stage 0, 20 VolSDF steps regularised
     by its volumes, the three 576x768 feedback renders (fused SDF
     kernel), stages 1 and 2 on the fed-back depth, the PFMs and cam
     files; the three stages of the run's first view recomputed on the
     CPU from the same inputs and bridged weights, against the card's
     (the engine keeps TF32 off on its own; this script sets no TF32
     flag); then the three stages of one view at 64x96 on the card
     against the CPU; then the same scene at the JAX defaults (bf16
     cascade convs, bf16 training), its volumes checked and its stage-0
     prob of the first view held to the float32 run's. Prints each
     stage's seconds and peak memory, the render seconds per view, the
     step median, and the seconds of writing the outputs (PFMs, PNG
     visualisations, cams, image copies), for both runs;
  7. fusion and evaluation, on phase 6's float32 1152x1536 outputs: (a)
     the geometric-consistency kernel against its plain version on the
     card on all 6 ordered view pairs (masks equal, depth <= 1e-12, x/y
     <= 1e-9), timed (median of 20) against its bound, the larger of its
     bytes' time and its FP64 instructions' (counted in its SASS,
     `tools/fp64_count.py`, at 64 a clock per SM at the SM clock's
     maximum), and the plain version; (b) the command line
     `cli.run.main([... filter_only=true])` on that directory, with eval masks for the training views, its PLY
     held to a CPU `fuse_views` of the same files (equal count, xyz
     within one float32 ulp, rgb equal); fusion seconds, the kernel's
     share, the point count; (c) the Chamfer distance to points on the
     fixture's sphere (radius 0.8 x 200 = 160) of that cloud (random
     weights need not put it on the sphere) and of the cloud the same
     cameras fuse from the sphere's own depths (acc below 1),
     seconds of the downsampling and of the NN queries; (d) the command
     line end to end at 64x96 on the card with no precision override
     (PFMs, PNGs, PLY and the trainer's checkpoints written);
  8. evaluation: (a)-(c) right after phase 5, on phase 4's float32
     trainer before it goes, (d) and (e) after phase 7: (a) a checkpoint
     round trip (save, load into a fresh VolTrainer(is_continue=True):
     every leaf and the CUDA generator bit-equal; 3 more steps on each:
     losses and parameters bit-equal), save and load ms; (b)
     render_image of view 0 at 576x768 (fast=-1; seconds, fused
     launches, peak memory, finite maps), its depth against
     render_depth's (printed), a 6x8 render_image card vs the CPU's
     plain path (2e-4); (c) export_mesh at 512^3 over plot.grid_boundary
     (extract_mesh_high_res) and at 256^3 through a bbs.npz
     (extract_mesh_by_grid): seconds of the 100^3 pass, the 512^3 grid
     (64 launches), marching tetrahedra (csrc/mc.cpp), the largest
     component, the PLY write, the counts, the host's peak memory; the
     plain MLP at up to 65,536 of each mesh's vertices within one
     voxel; the kernel on a 64^3 sub-grid against the plain MLP (1e-4);
     the per-launch grid points equal to the whole grid's; (d)
     eval_rendered_views on two 576x768 eval views of phase 6's fixture
     rendered with its float32 trainer (PSNR, SSIM, LPIPS with random
     VGG weights the phase writes as a checkpoint; seconds per view);
     (e) cli.eval_vsdf on phase 7(d)'s checkpoint at 64x96
     (--eval_rendering --eval_mesh --resolution 64: 28 views and a mesh;
     then --result_from default), and cli.eval_dtu --mode mesh of that
     mesh against 7(c)'s sphere points in an official-DTU layout;
  9. the other cascades: (a) (printed with phase 3) the deformable-conv
     kernel against its plain version at TransMVSNet's nine head shapes
     of x2 DTU (Cin 32: 32/32/32 at 288x384, 32/32/16 at 576x768,
     32/32/8 at 1152x1536; random offsets with a 2-pixel spread, masks
     in (0, 1); within 1e-5 (1 + |plain|)), the 1152x1536 32->32 launch
     timed on those inputs (with the share of samples outside their
     16x16 tile's window) and with zero offsets, against the plain
     version and its bound (three TF32 products at 495 TFLOP/s; the
     FP32-pipe bound of the first design beside it); (b) `save_scene_depth` with
     mvs.model_name=ucsnet and transmvsnet on phase 6's fixture at x2
     (1152x1536, D 192/32/8, 20 steps, three feedback renders) at the
     JAX defaults, He-gain convs and random DCN offset convs: stage
     seconds and peak memory, 27 deformable-conv launches on the
     TransMVSNet scene, 20 bf16 fused-SDF launches on each; (c) each
     model's three stages at 64x96 on the card against the CPU in
     float32 (prob, regressed depth; TransMVSNet's winner-take-all
     hypothesis where the top two probabilities are more than PROB_TOL
     apart, and its confidence); (d) `cli.run.main` at 64x96 with each
     model;
 11. (run before 10's results) BlendedMVS, the NeRF++ background model
     of the bmvs preset at its full widths, on a scene of JPEG images
     (12(a)): (a) the fused SDF kernel at
     bounding_sphere 0 in both modes on 65,536 points in a ball of
     radius 2r against its plain version (1e-4; 2^-7 (|sdf| + 1)), the
     clamped call (bounding_sphere r) differing on the points outside
     the sphere, timed; (b) the background training step at bench.py's
     shapes (512 rays, three 192x288x384 volumes), 20 steps at the
     defaults and 20 in float32 (finite losses, grad_finite, one
     fused-SDF launch a step), each then 5 steps under torch.profiler:
     median step ms, device ms, busy share, launches a step; (c)
     `save_scene_depth` and `pcd_filter` on a 576x768 BMVS fixture
     (scan1: stage 0 in inverse depth) at x2 MVS shapes with the full
     casmvsnet at He's gain, 20 background steps at the defaults: stage
     seconds and peak memory, render seconds per view, the fused,
     cost_mapping and geo_consistency launches, finite PFMs, the fused
     cloud's size; (d) `render_image` of eval view 19 with its near pose
     at 576x768 (seconds, peak memory) and `cli.eval_bmvs` of the fused
     cloud against points on the fixture's sphere written as
     BlendedMVS/stl/scan1.ply (printed: at scan1's relative scale its 20
     mm bound is 0.02 fixture units, so it is NaN) and against itself
     (0);
 12. (run before 10's results) the image path: (a) phase 11's scene
     was written as JPEGs (quality 95, 4:2:0, `make_bmvs_fixture(
     image_format="jpg")`), so its data path read them through
     csrc/jpeg.cpp; the host milliseconds to decode one 576x768 image
     and its PSNR against the fixture's source (at least 35 dB); (b)
     `image_based_render` on the card at 576x768 with GT depths
     (tests/test_ibr.py's sphere scene: three training views, the eval
     view under each of the 25 DTU eval ids): seconds per eval view, the
     blend's PSNR against the GT eval image (above 20 dB, the JAX test's
     bar); then, outside the counted run, on the first eval view: the
     geometric-consistency kernel against its plain version at IBR's
     inputs (576x768, filter_dist 2.0, with x/y; masks equal, x/y within
     1e-9), the share of the eval view's sphere pixels that some training
     view passes (at least 0.9) and the warped training images' PSNR
     against the GT view on their passing pixels (at least 40 dB each),
     and the blend on the card against the CPU's (1e-5); (c) the
     command-line chain at 64x96: `cli.run create_scene=
     true` on phase 7(d)'s fixture, `cli.ibr` on phase 8(e)'s
     rendering_<epoch> folder, `cli.eval_vsdf --result_from blend`
     (25 blends, finite metrics). The geometric-consistency kernel
     (with its x/y outputs) launches three times a blended view;
 13. (run before 10's results) multi-scene training in lockstep: (a)
     with 4 scenes of SDF weights from 4 seeds, the fused kernel at 4 x
     65,536 points in each mode in one launch, equal to 4 single
     launches bit for bit and within the bars of phase 3 of its plain
     version, and the cost-mapping kernel at 4 x (512 x 96) samples on 4
     scenes' 192x288x384 volumes (bf16 and float32) in one launch, equal
     to 4 single launches bit for bit in pj, pi and valid; the batched
     launch's ms beside the 4 single launches' (cold and warm for the
     cost mapping) and its bound; (b) the lockstep step (`run_joint`) at
     full width on 576x768 sphere scenes of per-scene radius with
     bench.py's volumes, S = 1, 2 and 4, 20 steps each at the defaults
     and at float32: finite losses, one fused-SDF launch of S scenes and
     one cost-mapping launch a step; at float32, S = 1 and 2 against
     serial trainers of the same seeds (step 1 within 1e-4 relative, 20
     steps within 1%); the median step, device ms, busy share, launches
     a step (torch.profiler, 5 more steps), peak GiB and training rays/s
     beside S serial steps' total; then NaN in scene 1's RGB for one
     step: its grad_finite 0, its parameters and Adam state equal to the
     bit, scene 0 stepping; (c) `cli.run multiscene=true` on two 64x96
     DTU fixtures (scan106, scan114; 30 float32 steps) against a serial
     `cli.run` of the same scans: every view's depth PFM within 1e-3 on
     at least 99.5% of its pixels, each scene's "latest" checkpoint
     resuming at step 30;
 14. (run before 10's results) multi-device on the one card: (a) one
     NCCL rank in this process at bench.py's shapes, at the defaults and
     at float32: make_sharded_train_step on an injected batch equal to
     train_step to the bit, 20 steps of the ray-sharded loop (finite
     losses) beside the single-process loop's (median, device ms, busy
     share and launches a step), the flat gradient all-reduce's us and
     bytes; (b) two gloo ranks sharing the card (spawned, float32): the
     sharded step at 256 rays a rank against one process's on the same
     512 rays and jitter within the one-step bars of
     tests/test_torch_train_step.py, the replicas bit-equal after 5
     steps (and at the defaults within their bf16 bars: each leaf 1e-1,
     the whole gradient 2e-2 in L2), one fused-SDF and one cost-mapping
     launch a step in each rank, a sharded 576x768 render_depth against one process's (equal,
     or 99.5% of the pixels within 1e-3); its times are two processes on
     one card, not scaling; (c) cli.run under three gloo ranks on phase
     7(d)'s 64x96 fixture, 30 float32 steps of 510 rays: stage 0 one
     view a rank within 1e-5 of one process, ray-sharded training, each
     PFM, PNG and PLY written once with finite depths. Each group of
     spawned ranks has a join timeout;
 15. (run before 10's results) the repository's tools without JAX: (a)
     the reference's checkpoints converted on this machine: CasMVSNet,
     UCSNet and TransMVSNet at the dtu widths from seed 0 (He-gain convs,
     random DCN offset convs), LPIPS and the dtu VolSDF field from seed 0,
     each written by `data.fixtures.reference_state_dict` in the
     reference's key names and layouts and saved with torch.save
     ({"epoch", "model", "optimizer"}; VolSDF as a bare state dict in
     both weight-norm key styles), converted by `python -m
     s_volsdf_tpu_torch.tools.convert_ckpt` in processes where `import
     jax` fails, all at once; the VolSDF fields loaded
     (`bridge.load_volsdf_checkpoint`; every leaf equal to the source)
     and the fused SDF kernel on them against its plain version at
     65,536 points (1e-4); each cascade loaded by `MVSEngine(weights_path=)`
     on the card (every leaf equal to the source) and on the CPU, stage 0
     of a 64x96 fixture's first view on both (prob 1e-4, depth 1e-5
     relative; TransMVSNet's winner-take-all and confidence; its 27
     deform_conv launches with the converted tap-major weights); LPIPS
     loaded on the card (leaves equal) and `eval_rendered_views` of two
     held-out 64x96 views on the card against the CPU (1e-5); (b)
     `tools.run_100k` at the dtu preset, full widths, 576x768, GT prior,
     chunks of 5 steps (a checkpoint every 200): a process killed after
     step 250 (exit code 17, no kill-site checkpoint), then `--resume` in
     this process to 300: the replayed rows 205-250 equal the killed
     run's in every field but chunk_s, wall, phase and card, no guard
     trip, finite radial errors; the median chunk, the resume's set-up
     and the feedback renders' seconds; (c) `tools.run_flagship` on that
     run (two held-out views): fused points, finite Chamfer, PSNR and
     SSIM, its seconds. The launches on (a)'s stages, (b)'s resume and
     (c) are counted (the killed process's are not);
 16. (run before 10's results) the paired stream of
     tests/test_torch_trajectory.py on the card (`tools.trajectory`): the
     port's step at the dtu defaults, full width, on a 192x256 DTU
     fixture with the GT prior, fed the port's draws from one CPU
     generator; step 1 on the card held to step 1 on the CPU on every
     loss term, the PSNR and the gradient norm (TRAJ_STEP1_BARS), its
     first 10 steps within the CPU trajectory test's bars at the
     defaults (`trajectory.BARS`) on the terms one gated ray's flip does
     not jump (TRAJ_HELD), the RGB term's and the PSNR's parting
     printed; then the
     card alone to step 300, across the RGB anneal (200), rgb, PSNR and
     beta printed every 50 steps; one bf16 fused SDF and one
     cost-mapping launch a step; then the plateau leg (`plateau_leg`):
     the JAX package's TrainState of its seed-2 loop at step 250
     (runs_torch/plateau_jax_seed2_s250.npz, on the post-anneal colour
     plateau) carried by name into the CPU's and the card's trainers,
     step 1 from it held card vs CPU within TRAJ_STEP1_BARS and its
     eikonal term (the softplus derivative's term) within that bar of
     the JAX package's value on the same batch (PLATEAU_JAX_ROWS), then
     100 card steps, one launch of each kernel a step, the RGB L1 and
     PSNR printed at 50 and 100 with the escape step, and the leg's
     seconds;
 10. a JSON line with the kernels' numbers (the fused kernel's
     `unclamped_launches`: its launches on phase 11's paths, all at
     bounding_sphere 0; both kernels' `scene_launches`, their launches
     on phase 13's paths by number of scenes, and `lockstep_launches`,
     those of more than one scene, with `scenes_*` times from 13(a);
     every kernel's `sharded_launches`, its launches on phase 14's paths
     in this process and the spawned ranks; `production_launches`, its
     launches on phase 15's paths; `trajectory_launches`, on phase
     16's card run),
     the card's name and power limit, and the last line {"ok": true,
     "device": {...}}.

Any failed check raises, so the script exits non-zero and prints no
result; so does a machine without a CUDA device. Weights are random,
from seed 0. Each path's launch counts are set to 0 just before it is
driven and read just after.

The helpers `float32_dtu_config`, `make_volumes` and `make_trainer` are
shared with the CPU tests of the same loop (tests/test_torch_trainer.py,
tests/test_torch_precision.py), `cascade_config` and
`cascade_card_vs_cpu`, `dcn_inputs` and `DCN_HEADS` with
tests/test_torch_cuda.py.
"""

from __future__ import annotations

import copy
import dataclasses
import hashlib
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from itertools import permutations
from typing import Dict

import numpy as np
import torch

from s_volsdf_tpu_torch.bridge import (from_jax_mvs_params,
                                       load_volsdf_checkpoint, to_jax_params,
                                       to_jax_mvs_params)
from s_volsdf_tpu_torch.cli import eval_bmvs as cli_eval_bmvs
from s_volsdf_tpu_torch.cli import eval_dtu as cli_eval_dtu
from s_volsdf_tpu_torch.cli import eval_vsdf as cli_eval_vsdf
from s_volsdf_tpu_torch.cli import ibr as cli_ibr
from s_volsdf_tpu_torch.cli import run as cli_run
from s_volsdf_tpu_torch.config import (Config, bmvs_config, dtu_config,
                                       load_config, per_scene_overrides)
from s_volsdf_tpu_torch.data.fixtures import (make_bmvs_fixture,
                                              make_dtu_fixture,
                                              reference_checkpoint,
                                              reference_state_dict)
from s_volsdf_tpu_torch.data.io import (load_ply, read_img, read_pfm,
                                        save_pfm, save_ply, write_cam,
                                        write_png)
from s_volsdf_tpu_torch.data.jpeg import decode_jpeg
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset
from s_volsdf_tpu_torch.data.scene_dataset import (load_scene,
                                                   scene_from_synthetic)
from s_volsdf_tpu_torch.data.splits import get_eval_ids, get_trains_ids
from s_volsdf_tpu_torch.data.synthetic import gt_prob_volume, make_sphere_scene
from s_volsdf_tpu_torch.engine import eval_geo
from s_volsdf_tpu_torch.engine import mesh as mesh_mod
from s_volsdf_tpu_torch.engine.eval_nvs import eval_rendered_views, export_mesh
from s_volsdf_tpu_torch.engine.fusion import (filter_depth, fuse_views,
                                              load_views)
from s_volsdf_tpu_torch.engine import ibr as ibr_mod
from s_volsdf_tpu_torch.engine.ibr import image_based_render
from s_volsdf_tpu_torch.engine.mesh import mesh_sdf_fn
from s_volsdf_tpu_torch.engine.render import render_depth, render_image
from s_volsdf_tpu_torch.engine.runner import (MVSEngine, pcd_filter,
                                              run_mvs_stage, save_scene_depth,
                                              setup_scene)
from s_volsdf_tpu_torch.engine.train_step import (draw_step_inputs,
                                                  loss_and_grads,
                                                  mean_over_group,
                                                  pack_for_chunk, shard_batch,
                                                  train_step,
                                                  training_model_config)
from s_volsdf_tpu_torch.engine.multiscene import run_joint
from s_volsdf_tpu_torch.engine.trainer import VolTrainer, stack_states
from s_volsdf_tpu_torch.models.layers import softplus_b
from s_volsdf_tpu_torch.models.lpips import (VGG_PLAN, init_lpips_params,
                                            load_lpips, lpips_leaves)
from s_volsdf_tpu_torch.models.network import (init_volsdf_params,
                                               render_rays, stack_params)
from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs.transmvsnet import DCN
from s_volsdf_tpu_torch.ops import (cost_mapping, deform_conv, fused_sdf,
                                    geo_consistency)
from s_volsdf_tpu_torch.ops.cost_mapping import MVSVolumes
from s_volsdf_tpu_torch.parallel import mesh as pmesh
from s_volsdf_tpu_torch.parallel.train_parallel import (
    make_sharded_scan_train_fn, make_sharded_train_step)
from s_volsdf_tpu_torch.tools import run_100k, run_flagship, trajectory
from s_volsdf_tpu_torch.tools.fp64_count import fp64_instructions
from s_volsdf_tpu_torch.tools.time_cost_mapping import (cold_ms, sample_sets,
                                                        samples)
from s_volsdf_tpu_torch.utils import checkpoint as ckpt
from s_volsdf_tpu_torch.utils.device import card_name
from s_volsdf_tpu_torch.utils.image import remap_cubic

# The kernel's bf16 x 3 split (about 2^-16 of each product) and f32 sums
# in another order across 9 layers.
KERNEL_TOL = 1e-4
# The bfloat16 mode against its plain bf16 version: |d| <= 2^-7 (|sdf| +
# 1), 7.8e-3, two bf16 units. wgmma sums each layer in another order than
# the plain matmul, which moves a bf16 rounding of an activation now and
# then and the SDF with it: measured up to 3.2e-3 (|sdf| + 1) at
# 2,097,152 points on an H100, within 2.5x of the bar.
BF16_KERNEL_UNITS = 2.0 ** -7
# ... and the mean of |d| / (|sdf| + 1) over 65,536 points or more.
# Sums in another order leave it at 1.6e-5 (the kernel against its
# plain version on an H100; PERF.md, PR 15); the kernel that rounded its
# softplus once, where the plain version rounds op by op (before PR 15),
# reads 8.0e-4 against the same plain version, inside the max bar above
# (5.5e-3) and 8x past this one.
BF16_KERNEL_MEAN = 1e-4
# The activation (act2_bf16: its table of torch's bf16 ops over the band
# 2^-16 <= |h| < 1, closed forms outside it; through fused_sdf_act_bf16)
# against torch's bf16 ops on the card over every finite bf16 input:
# equal wherever either result is a normal float (measured: all 65,280,
# as the op-by-op MUFU form before it). Rounded once it differs on 4,077.
ACT_MISMATCHES = 0
KERNEL_SWEEP, KERNEL_RENDER = 65536, 2097152   # one step's sweep, one render launch
BF16_TFLOPS = 989.0   # the H100's dense bf16 tensor-core peak
RENDER_TOL = 2e-4     # the VolSDF render bar (README "Verified parity")
TRAIN_STEPS = 20
# cost_mapping against its plain version: the same float32 operations in
# the same order (--fmad=false), the views summed in the same order:
# bit-equal; masks equal.
COST_TOL = 0.0
COST_RAYS, COST_SAMPLES = 512, 96   # one step: 512 rays x (64 + 32) samples
BENCH_VOLUMES = (192, 288, 384)     # bench.py's three stage-0 volumes
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
# TransMVSNet's winner-take-all depth is compared where the top two
# probabilities differ by more than PROB_TOL: elsewhere argmax may pick
# either hypothesis on either side.
OTHER_MODELS = ("ucsnet", "transmvsnet")
# The deformable-conv kernel against its plain version: float32 sums of
# 9 x 32 products (and each sample's four corners) in another order, on
# unit-scale inputs.
DCN_TOL = 1e-5
DCN_CIN = 32
# TransMVSNet's nine deformable convs a view at x2 DTU shapes: each
# head's scale and its three DCNs' Cout.
DCN_HEADS = ((4, (32, 32, 32)), (2, (32, 32, 16)), (1, (32, 32, 8)))
DCN_PER_VIEW = sum(len(c) for _, c in DCN_HEADS)
# One kernel launch per DCN call, whatever its batch: the backbone runs a
# scene's 3 views one at a time (as the reference's orchestrator does),
# so a TransMVSNet scene or command line launches 9 x 3.
DCN_LAUNCHES_A_SCENE = DCN_PER_VIEW * 3
# The DCNs' offset convs are zero at init (a DCN starts as a plain conv):
# the smoke run puts random ones in place, this many times the uniform
# +-sqrt(1/fan_in) init, so that offsets of a few pixels (some past the
# edges) and masks away from 0.5 occur.
OFFSET_GAIN = 4.0
FP32_LANES_PER_SM = 128   # the H100's FP32 pipe: 128 FMAs a clock per SM
TF32_TFLOPS = 495.0       # the H100's dense TF32 tensor-core peak
# Fusion: the kernel repeats the host C++'s float64 arithmetic
# (--fmad=false), so it is held to its plain version at these bars.
FUSION_DEPTH_TOL, FUSION_XY_TOL = 1e-12, 1e-9
HBM_TBPS = 3.35       # the H100's device-memory rate
# FP64 instructions an H100 SM issues per clock outside the tensor cores:
# 34 TFLOP/s (NVIDIA's H100 SXM data sheet) = 132 SMs x 64 x 2 (an FMA is
# two flops) x 1.98 GHz.
FP64_PER_SM_CLOCK = 64
SPHERE_RADIUS = 0.8 * 200.0   # the fixture's sphere in its DTU-like frame
GT_POINTS = 1_000_000
# The fused cloud of the sphere's own depths against points on it: the
# GT points lie about 0.57 apart, so its accuracy (mean distance of the
# cloud to the sphere's points) is a fraction of a unit; 1.0 flags a
# wrong frame or scale. (Its completeness is not gated: three views see
# part of the sphere, and the GT points just past their silhouettes
# count up to max_dist each.)
TRUTH_ACC_TOL = 1.0
SMALL_CLI_STEPS = 3
SMALL_VSDF = "small_vsdf"   # phase 7(d)'s exps_folder under the temp dir
SMALL_EVALS = "small_evals"   # phase 8(e)'s evals_folder under the temp dir
# SDF MLPs outside the fused kernel's family (`fused_sdf.supported`), run
# through the sampler's plain route: two skip junctions, and a hidden
# width past the kernel's 256.
OUTSIDE_FAMILY = {"skip_in (2, 4)": {"skip_in": (2, 4)},
                  "width 320": {"dims": (320,) * 8}}
OUTSIDE_STEPS = 3
# A queued device sleep (cycles) that hides a wrapper's host time when a
# kernel alone is timed.
BACKLOG_CYCLES = 5_000_000


def float32_config(cfg: Config) -> Config:
    """cfg with the three training precision knobs and the cascade's at
    float32 (their JAX defaults are bf16)."""
    cfg.train.train_compute_dtype = "float32"
    cfg.train.train_activation_dtype = "float32"
    cfg.train.mvs_pack_dtype = "float32"
    cfg.mvs.compute_dtype = "float32"
    return cfg


def float32_dtu_config() -> Config:
    """The dtu preset at float32 (`float32_config`)."""
    return float32_config(dtu_config())


def make_volumes(scene, vol_shape, device) -> MVSVolumes:
    """Informative float32 MVS volumes (D, Hc, Wc) for every view, with
    bench.py's arguments (sigma 1 interval, floor 0.02, depth noise
    2.5/200, hypotheses linspace(0.5, 5.0, D)); a trainer stores them in
    its train.mvs_pack_dtype when it runs."""
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


def make_trainer(cfg: Config, img_res, vol_shape, device,
                 exps_root=None) -> VolTrainer:
    """A VolTrainer on a 3-view sphere scene with informative volumes,
    one step per chunk (so chunk_seconds are step times); with
    exps_root, its run directory there (as scan106)."""
    scene = make_sphere_scene(3, img_res)
    trainer = VolTrainer(cfg, scene_from_synthetic(scene),
                         SCAN if exps_root else None, device=device,
                         exps_root=exps_root, chunk_steps=1)
    trainer.mvs = make_volumes(scene, vol_shape, device)
    return trainer


def cascade_config(data_root: str, img_res, ndepths, x2_mvsres: bool,
                   opt_stepNs, base=float32_dtu_config) -> Config:
    """The dtu preset (`base`: float32, or `dtu_config` for the JAX
    defaults) reading the DTU-layout fixture under data_root at img_res,
    with the cascade's hypothesis counts."""
    cfg = base()
    cfg.data_dir_root = cfg.dataset.data_dir_root = data_root
    cfg.max_h, cfg.max_w = img_res
    cfg.dataset.img_res = tuple(img_res)
    cfg.mvs.ndepths, cfg.mvs.numdepth = tuple(ndepths), ndepths[0]
    cfg.mvs.x2_mvsres = x2_mvsres
    cfg.mvs.interval_scale = 1.06
    cfg.opt_stepNs = tuple(opt_stepNs)
    return cfg


def stages_against_cpu(card: MVSEngine, sample, card_outs,
                       card_extras=None, cpu=None) -> Dict[str, float]:
    """Recompute the three cascade stages of one MVS sample on the CPU,
    with the card engine's weights (through the bridge), from the inputs
    the card's stages had (or with the CPU engine `cpu`): the sample's
    images, and for stages 1 and 2
    the depth the card's previous stage handed on (`card_outs[k - 1]
    ["depth"]`, on the host; after a stage with an optimisation budget,
    the VolSDF feedback render) and its `extra` (`card_extras[k - 1]`:
    UCSNet's variance, TransMVSNet's view weights). The CPU computes its
    own features. Returns the largest |prob_volume| difference, the
    largest relative difference of the regressed depth sum(prob *
    hypotheses) over the stages, for TransMVSNet also the pixels whose
    winner-take-all hypothesis differs where the CPU's top two
    probabilities are more than PROB_TOL apart ("wta") and the largest
    confidence difference, and the CPU's seconds."""
    cfg = card.cfg
    if cpu is None:
        cpu = MVSEngine(cfg, device="cpu")
        cpu.net = from_jax_mvs_params(to_jax_mvs_params(card.net),
                                      cfg.mvs.ndepths, cfg.mvs.cr_base_chs,
                                      device="cpu", model=cfg.mvs.model_name)
    card_extras = card_extras or [None] * len(card_outs)
    t0 = time.perf_counter()
    feats = cpu.sample_features(cpu.scene_feature_cache(sample.imgs),
                                list(range(len(sample.view_ids))))
    hw = sample.imgs.shape[1:3]
    errs = {"prob": 0.0, "depth_rel": 0.0}
    for stage, got in enumerate(card_outs):
        extra = card_extras[stage - 1] if stage else None
        want, _ = cpu.stage(
            stage, feats, sample.proj_matrices[f"stage{stage + 1}"],
            sample.depth_values,
            None if stage == 0 else card_outs[stage - 1]["depth"],
            None if extra is None else extra.cpu(), hw,
            inverse_depth=cfg.inverse_depth and stage == 0)
        pv, dv = got["prob_volume"].cpu(), got["depth_values"].cpu()
        errs["prob"] = max(errs["prob"],
                           (pv - want["prob_volume"]).abs().max().item())
        want_depth = (want["prob_volume"] * want["depth_values"]).sum(0)
        errs["depth_rel"] = max(errs["depth_rel"], ((pv * dv).sum(0)
                                - want_depth).abs().div(
                                    want_depth.abs()).max().item())
        if cfg.mvs.model_name == "transmvsnet":
            top2 = want["prob_volume"].topk(2, dim=0).values
            sure = (top2[0] - top2[1]) > PROB_TOL
            wta = pv.argmax(0) != want["prob_volume"].argmax(0)
            errs["wta"] = errs.get("wta", 0) + int((wta & sure).sum())
            errs["conf"] = max(errs.get("conf", 0.0), (torch.as_tensor(
                got["photometric_confidence"]).cpu()
                - want["photometric_confidence"]).abs().max().item())
        del want, pv, dv
    errs["cpu_s"] = time.perf_counter() - t0
    return errs


def random_offsets(net: torch.nn.Module, seed: int = 1) -> None:
    """Every DCN offset conv of `net` uniform in +-OFFSET_GAIN /
    sqrt(fan_in), in place (a no-op for nets without DCNs)."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, DCN):
                w = m.offset_conv.weight
                bound = OFFSET_GAIN / w[0].numel() ** 0.5
                w.copy_(torch.rand(w.shape, generator=gen) * (2 * bound)
                        - bound)


def cascade_card_vs_cpu(device, data_root: str,
                        model: str = "casmvsnet") -> Dict[str, float]:
    """The three cascade stages of `model` on the first reference view
    of a 64x96 fixture (written under data_root if absent), x2_mvsres
    off, D = 16/8/8, float32, chained on `device`, then held against the
    CPU (`stages_against_cpu`). UCSNet and TransMVSNet run at He's gain
    (`he_gain`) with random offset convs (`random_offsets`)."""
    if not os.path.isdir(os.path.join(data_root, "DTU")):
        make_dtu_fixture(data_root, img_res=SMALL_RES)
    cfg = cascade_config(data_root, SMALL_RES, SMALL_NDEPTHS, False,
                         (0, 0, 0))
    cfg.mvs.model_name = model
    sample = MVSDataset(
        datapath=os.path.join(data_root, "DTU", "mvs_data"), scan=SCAN,
        nviews=cfg.num_view, data_dir="DTU", ndepths=cfg.mvs.numdepth,
        interval_scale=cfg.mvs.interval_scale, max_h=cfg.max_h,
        max_w=cfg.max_w, trains_i=get_trains_ids("DTU", SCAN, cfg.num_view),
        data_dir_root=data_root, x2_mvsres=False)[0]
    card = MVSEngine(cfg, device=device)
    if model != "casmvsnet":
        he_gain(card.net)
        random_offsets(card.net)
    feats = card.sample_features(card.scene_feature_cache(sample.imgs),
                                 list(range(len(sample.view_ids))))
    outs, extras, prev, extra = [], [], None, None
    for stage in range(3):
        out, extra = card.stage(
            stage, feats, sample.proj_matrices[f"stage{stage + 1}"],
            sample.depth_values, prev, extra, sample.imgs.shape[1:3],
            inverse_depth=False)
        prev = out["depth"] = out["depth"].cpu().numpy()
        outs.append(out)
        extras.append(extra)
    return stages_against_cpu(card, sample, outs, extras)


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


def he_gain(net: torch.nn.Module) -> None:
    """Every conv kernel of `net` times sqrt(6), in place: He's gain for
    the +-sqrt(1/fan_in) uniform init, so that random features keep their
    size through the ReLUs and the stage-0 probabilities are not uniform
    (with the plain init they are 1/D to the bit, and bf16 convs could
    not be told from float32 ones). The DCNs' (9 Cin, Cout) kernels
    too."""
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, B.CONVS):
                m.weight.mul_(6 ** 0.5)
            elif isinstance(m, DCN):
                m.w.mul_(6 ** 0.5)


def _scene_run(dev, card: str, cfg: Config, exps_root: str, what: str):
    """One `save_scene_depth` of phase 6 (or 9) with `cfg` and the
    He-gain cascade weights (random DCN offset convs), its launch counts
    set to 0 before and read after; checks its losses, feedback renders,
    volumes and files, and prints its numbers. Returns the engine, the
    result and its launches (`_launch_counts`)."""
    engine = MVSEngine(cfg, device=dev)
    he_gain(engine.net)
    random_offsets(engine.net)
    _reset_counts()                             # this path starts
    t0 = time.perf_counter()
    res = save_scene_depth(cfg, SCAN, exps_root=exps_root, engine=engine)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _launch_counts()
    trainer = res["trainer"]                    # ... and ends here

    losses = [lo.loss for lo in trainer.losses]
    _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
           f"cascade {what}: finite losses: {losses}")
    _check(len(res["feedback_launches"]) == 3
           and all(n > 0 for n in res["feedback_launches"]),
           f"cascade {what}: fused SDF launches per feedback render: "
           f"{res['feedback_launches']}")
    _check(launches["cost_mapping"] == TRAIN_STEPS,
           f"cascade {what}: cost_mapping launches {launches}")
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

    print(f"[cascade] {what}: save_scene_depth {SCAN}, MVS {H2}x{W2}, D "
          f"{'/'.join(map(str, CASCADE_NDEPTHS))}, {TRAIN_STEPS} steps: "
          f"{total_s:.2f} s [{card}]", flush=True)
    for stage, (sec, peak) in enumerate(zip(res["stage_seconds"],
                                            res["stage_peak_bytes"])):
        print(f"[cascade] {what}: stage {stage}: {sec:.3f} s for 3 views, "
              f"peak allocated {peak / 2**30:.2f} GiB [{card}]", flush=True)
    step_ms = 1e3 * float(np.median(trainer.step_seconds))
    mvs_losses = [lo.mvs_loss for lo in trainer.losses]
    print(f"[cascade] {what}: {TRAIN_STEPS} steps on stage 0's volumes: "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}, mvs loss "
          f"{mvs_losses[0]:.5f} -> {mvs_losses[-1]:.5f}, median "
          f"{step_ms:.2f} ms/step [{card}]", flush=True)
    print(f"[cascade] {what}: feedback renders {CASCADE_RES[0]}x"
          f"{CASCADE_RES[1]}: "
          + ", ".join(f"{sec:.3f} s" for sec in res["feedback_seconds"])
          + f"; fused SDF launches {res['feedback_launches']}; launches on "
          f"the path {launches} [{card}]", flush=True)
    print(f"[cascade] {what}: outputs (PFMs, PNG visualisations, cams, "
          f"image copies) written in {res['outputs_seconds']:.3f} s, of "
          f"which the PNGs {png_seconds(res):.3f} s (re-encoded) [{card}]",
          flush=True)
    return engine, res, launches


def run_cascade(dev, card: str, tmp: str):
    """Phase 6 (see the module docstring); returns the launches on its
    two paths (`_scene_run`), the float32 run's result and the fixture's
    data root."""
    data_root = os.path.join(tmp, "data")
    t0 = time.perf_counter()
    make_dtu_fixture(data_root, img_res=CASCADE_RES)
    print(f"[cascade] {CASCADE_RES[0]}x{CASCADE_RES[1]} DTU fixture written "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    args = (data_root, CASCADE_RES, CASCADE_NDEPTHS, CASCADE_X2,
            (TRAIN_STEPS, 0, 0))
    engine, res, launches = _scene_run(dev, card, cascade_config(*args), tmp,
                                       "float32")
    H2, W2 = CASCADE_MVS_RES

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
    del engine

    errs = cascade_card_vs_cpu(dev, os.path.join(tmp, "small"))
    _check(errs["prob"] <= PROB_TOL and errs["depth_rel"] <= DEPTH_RTOL,
           f"cascade card vs CPU: {errs} (tol prob {PROB_TOL}, depth "
           f"rel {DEPTH_RTOL})")
    print(f"[cascade] 3 stages at {SMALL_RES[0]}x{SMALL_RES[1]}, D "
          f"{'/'.join(map(str, SMALL_NDEPTHS))}, card vs CPU: prob max|diff| "
          f"{errs['prob']:.3e} (tol {PROB_TOL}), depth max rel diff "
          f"{errs['depth_rel']:.3e} (tol {DEPTH_RTOL})", flush=True)

    # The same scene at the JAX defaults: bf16 cascade convs, bf16
    # training, bf16 volumes, float32 feedback renders.
    f32_prob = res["outs"][0]["stage1"]["prob_volume"]
    _, dres, dlaunches = _scene_run(
        dev, card, cascade_config(*args, base=dtu_config),
        os.path.join(tmp, "defaults"), "defaults")
    _check(dlaunches["fused_sdf"]["bfloat16"] == TRAIN_STEPS,
           f"bf16 fused-SDF launches on the defaults' scene: {dlaunches}")
    prob = dres["outs"][0]["stage1"]["prob_volume"]
    err = (prob - f32_prob).abs().max().item()
    _check(err <= PROB_TOL, f"stage-0 prob, bf16 convs vs float32: {err}")
    print(f"[cascade] defaults vs float32: stage-0 prob of view "
          f"{dres['samples'][0].view_ids[0]} max|diff| {err:.3e} (tol "
          f"{PROB_TOL}; its spread over hypotheses and pixels "
          f"{(f32_prob.max() - f32_prob.min()).item():.3e})", flush=True)
    del dres, prob, f32_prob
    return {"float32": launches, "defaults": dlaunches}, res, data_root


def _sm_clock_mhz() -> float:
    """The SM clock's maximum, as nvidia-smi reads it now."""
    return float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])


def dcn_inputs(H: int, W: int, cout: int, device, seed: int):
    """Unit-scale deformable-conv operands (x, offset, mask, weight,
    bias) at one head shape: offsets normal with a 2-pixel spread (some
    samples past every edge), masks uniform in (0, 1)."""
    gen = torch.Generator().manual_seed(seed)
    K, cin = deform_conv.TAPS, DCN_CIN
    x = torch.randn((cin, H, W), generator=gen)
    offset = 2.0 * torch.randn((2 * K, H, W), generator=gen)
    mask = torch.rand((K, H, W), generator=gen)
    bound = 1.0 / (K * cin) ** 0.5
    weight = torch.rand((K * cin, cout), generator=gen) * (2 * bound) - bound
    bias = 0.1 * torch.randn((cout,), generator=gen)
    return [t.to(device) for t in (x, offset, mask, weight, bias)]


def check_deform_conv(dev, card: str) -> Dict:
    """Phase 9(a): the deformable-conv kernel against its plain version
    at TransMVSNet's nine head shapes of x2 DTU, bar DCN_TOL (1 +
    |plain|); the 1152x1536 32 -> 32 launch timed on dcn_inputs (and
    again with zero offsets) against the plain version and its bound:
    the largest of its three TF32 products a multiply-add at
    TF32_TFLOPS, its corner blend on the FP32 pipe and its bytes at
    HBM_TBPS. The FP32-pipe bound of the first design (the contraction
    there too, at the SM clock's maximum) is printed beside it."""
    H2, W2 = CASCADE_MVS_RES
    err = worst = 0.0
    for head, (scale, couts) in enumerate(DCN_HEADS):
        H, W = H2 // scale, W2 // scale
        for i, cout in enumerate(couts):
            args = dcn_inputs(H, W, cout, dev, 10 * head + i)
            got = deform_conv.deform_conv2d(*args)
            ref = deform_conv.deform_conv2d_plain(*args)
            torch.cuda.synchronize()
            diff = (got - ref).abs()
            rel = (diff / (1 + ref.abs())).max().item()
            _check(rel <= DCN_TOL, f"deform_conv {DCN_CIN}->{cout} at "
                   f"{H}x{W}: {rel} (1 + |plain|) > {DCN_TOL}")
            err, worst = max(err, diff.max().item()), max(worst, rel)
            del got, ref, args
    args = dcn_inputs(H2, W2, DCN_CIN, dev, 99)
    share = deform_conv.outside_window_share(args[1])
    kernel_ms = _median_ms(lambda: deform_conv.deform_conv2d(*args),
                           backlog=True)
    plain_ms = _median_ms(lambda: deform_conv.deform_conv2d_plain(*args),
                          reps=5, backlog=True)
    zero = [args[0], torch.zeros_like(args[1])] + args[2:]
    zero_ms = _median_ms(lambda: deform_conv.deform_conv2d(*zero),
                         backlog=True)
    ref = deform_conv.deform_conv2d_plain(*zero)
    rel = ((deform_conv.deform_conv2d(*zero) - ref)
           / (1 + ref.abs())).abs().max().item()
    _check(rel <= DCN_TOL, f"deform_conv zero offsets: {rel}")
    clock_mhz = _sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fp32_rate = sms * FP32_LANES_PER_SM * 2 * clock_mhz * 1e6
    flop = deform_conv.flops(H2, W2, DCN_CIN, DCN_CIN)
    fp32_ms = flop / fp32_rate * 1e3
    tflop = deform_conv.tensor_flops(H2, W2, DCN_CIN, DCN_CIN)
    tensor_ms = tflop / (TF32_TFLOPS * 1e12) * 1e3
    blend_ms = deform_conv.blend_flops(H2, W2, DCN_CIN) / fp32_rate * 1e3
    nbytes = deform_conv.io_bytes(H2, W2, DCN_CIN, DCN_CIN)
    bytes_ms = nbytes / (HBM_TBPS * 1e12) * 1e3
    ops_ms = max(tensor_ms, blend_ms)
    bound_ms = max(ops_ms, bytes_ms)
    bound_by = "operations" if ops_ms >= bytes_ms else "bytes"
    print(f"[dcn] deform_conv vs plain at the nine head shapes (Cin "
          f"{DCN_CIN}; 288x384, 576x768, 1152x1536): max|diff| {err:.3e}, "
          f"{worst:.3e} (1 + |plain|) (tol {DCN_TOL}) [{card}]", flush=True)
    print(f"[dcn] {H2}x{W2} {DCN_CIN}->{DCN_CIN}: kernel {kernel_ms:.4f} ms "
          f"(device, median of 20; offsets with a 2-pixel spread, "
          f"{100 * share:.2f}% of the samples outside their tile's "
          f"window), {zero_ms:.4f} ms with zero offsets; bound "
          f"{bound_ms:.4f} ms by {bound_by} (three TF32 products "
          f"{tensor_ms:.4f} ms: {tflop / 1e9:.1f} GFLOP at {TF32_TFLOPS} "
          f"TFLOP/s; corner blend {blend_ms:.4f} ms on the FP32 pipe; bytes "
          f"{bytes_ms:.4f} ms: {nbytes / 1e9:.3f} GB at {HBM_TBPS} TB/s): "
          f"{100 * bound_ms / kernel_ms:.1f}% of bound; the FP32-pipe "
          f"bound of the first design {fp32_ms:.4f} ms ({flop / 1e9:.2f} GFLOP "
          f"at {sms} x {FP32_LANES_PER_SM} FMAs a clock, {clock_mhz:.0f} "
          f"MHz): {100 * fp32_ms / kernel_ms:.1f}% of it; plain "
          f"{plain_ms:.3f} ms [{card}]", flush=True)
    return {"max_abs_err": err, "ms": kernel_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "tensor_ms": tensor_ms, "blend_ms": blend_ms,
            "bytes_ms": bytes_ms, "fp32_bound_ms": fp32_ms,
            "ms_zero_offsets": zero_ms, "outside_window_share": share,
            "sm_clock_mhz": clock_mhz}


def run_other_cascades(dev, card: str, tmp: str, data_root: str):
    """Phase 9(b)-(d) (see the module docstring); returns the launches
    of each path driven, each counted from 0."""
    paths = []
    # (b) save_scene_depth at x2 DTU shapes, the JAX defaults.
    args = (data_root, CASCADE_RES, CASCADE_NDEPTHS, CASCADE_X2,
            (TRAIN_STEPS, 0, 0))
    for model in OTHER_MODELS:
        cfg = cascade_config(*args, base=dtu_config)
        cfg.mvs.model_name = model
        _, res, launches = _scene_run(dev, card, cfg,
                                      os.path.join(tmp, model),
                                      f"{model} defaults")
        want = DCN_LAUNCHES_A_SCENE if model == "transmvsnet" else 0
        _check(launches["deform_conv"] == want
               and launches["fused_sdf"]["bfloat16"] == TRAIN_STEPS,
               f"{model} scene: launches {launches}, want deform_conv "
               f"{want} and {TRAIN_STEPS} bf16 fused SDF")
        if model == "ucsnet":
            var = res["outs"][0]["stage3"]["variance"]
            _check(bool(torch.isfinite(var).all()), "ucsnet: finite variance")
        paths.append(launches)
        del res
    # (c) Three stages at 64x96 on the card against the CPU, float32.
    for model in OTHER_MODELS:
        errs = cascade_card_vs_cpu(dev, os.path.join(tmp, "small"), model)
        _check(errs["prob"] <= PROB_TOL and errs["depth_rel"] <= DEPTH_RTOL
               and errs.get("wta", 0) == 0
               and errs.get("conf", 0.0) <= PROB_TOL,
               f"{model} card vs CPU: {errs} (tol prob {PROB_TOL}, depth rel "
               f"{DEPTH_RTOL}, winner-take-all where the top two differ by "
               f"more than {PROB_TOL})")
        print(f"[other] {model}: 3 stages at {SMALL_RES[0]}x{SMALL_RES[1]}, "
              f"D {'/'.join(map(str, SMALL_NDEPTHS))}, card vs CPU: "
              + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
              + f" (tol prob {PROB_TOL}, depth rel {DEPTH_RTOL})", flush=True)
    # (d) The command line at 64x96 with each model, no precision override.
    for model in OTHER_MODELS:
        out = os.path.join(tmp, f"small_{model}")
        _reset_counts()                         # this path starts
        t0 = time.perf_counter()
        plys = cli_run.main(small_run_args(tmp, out) + [
            f"exps_folder={os.path.join(tmp, f'vsdf_{model}')}",
            f"mvs.model_name={model}", f"opt_stepNs=[{SMALL_CLI_STEPS},0,0]"])
        torch.cuda.synchronize()
        small_s = time.perf_counter() - t0
        launches = _launch_counts()             # ... and ends here
        want = DCN_LAUNCHES_A_SCENE if model == "transmvsnet" else 0
        _check(os.path.isfile(plys[0])
               and launches["deform_conv"] == want
               and launches["fused_sdf"]["bfloat16"] == SMALL_CLI_STEPS
               and launches["cost_mapping"] == SMALL_CLI_STEPS,
               f"{model} command line: {plys}, launches {launches}")
        print(f"[other] cli.run mvs.model_name={model} end to end {SCAN} at "
              f"{SMALL_RES[0]}x{SMALL_RES[1]}, {SMALL_CLI_STEPS} steps: "
              f"{small_s:.2f} s, {load_ply(plys[0])[0].shape[0]} points; "
              f"launches {launches} [{card}]", flush=True)
        paths.append(launches)
    return paths


def png_seconds(res) -> float:
    """The seconds of the three PNGs per view that save_scene_outputs
    writes (JET depth, grey confidence, image copy at MVS resolution),
    encoded again into a scratch directory from the run's PFMs."""
    from s_volsdf_tpu_torch.utils.viz import visualize_depth
    scan_dir = os.path.join(res["outdir"], SCAN)
    with tempfile.TemporaryDirectory() as tmp:
        total = 0.0
        for s in res["samples"]:
            v = s.view_ids[0]
            depth, _ = read_pfm(os.path.join(scan_dir, f"depth_est/{v:08d}.pfm"))
            conf, _ = read_pfm(os.path.join(scan_dir, f"confidence/{v:08d}.pfm"))
            t0 = time.perf_counter()
            write_png(os.path.join(tmp, "d.png"), visualize_depth(
                depth, depth_min=float(np.quantile(depth, 0.01)),
                depth_max=float(np.max(s.depth_values)))[..., ::-1], level=1)
            write_png(os.path.join(tmp, "c.png"),
                      visualize_depth(conf, direct=True), level=1)
            write_png(os.path.join(tmp, "i.png"), (np.clip(
                s.imgs[0], 0, 1) * 255).astype(np.uint8), level=1)
            total += time.perf_counter() - t0
    return total


def write_train_eval_masks(data_root: str) -> str:
    """DTU eval masks (the sphere's silhouette, at image resolution) for
    the fixture's training views, so that fusion's eval-mask path
    (dilation, resize to the MVS resolution) runs; returns their
    directory."""
    scene = make_sphere_scene(n_views=3, img_res=CASCADE_RES, cam_radius=2.8)
    mask_dir = os.path.join(data_root, "DTU", "eval_mask", SCAN)
    for v, vid in enumerate(get_trains_ids("DTU", SCAN, 3)):
        write_png(os.path.join(mask_dir, "mask", f"{vid:03d}.png"),
                  np.isfinite(scene.depths[v]).astype(np.uint8) * 255)
    return mask_dir


def sphere_points(n: int, seed: int = 0) -> np.ndarray:
    """n points uniformly on the fixture's sphere (centred at the
    origin, radius SPHERE_RADIUS), float32."""
    d = np.random.default_rng(seed).standard_normal((n, 3))
    return (d / np.linalg.norm(d, axis=1, keepdims=True)
            * SPHERE_RADIUS).astype(np.float32)


def sphere_depth(intr: np.ndarray, extr: np.ndarray, shape_hw) -> np.ndarray:
    """The z-depth (float32) of the fixture's sphere seen by a camera
    (intrinsics 3x3, world-to-camera 4x4) at integer pixel coordinates,
    as fusion reads them; 0 where the ray misses."""
    H, W = shape_hw
    u, v = np.meshgrid(np.arange(W, dtype=np.float64),
                       np.arange(H, dtype=np.float64))
    rays = np.stack([u, v, np.ones_like(u)], -1) @ np.linalg.inv(
        np.asarray(intr, np.float64)).T            # camera frame, z = 1
    R = np.asarray(extr, np.float64)[:3, :3]
    centre = -R.T @ np.asarray(extr, np.float64)[:3, 3]
    d = rays @ R                                    # R^T of each ray
    a, b = (d * d).sum(-1), 2.0 * (d @ centre)
    disc = b * b - 4.0 * a * (centre @ centre - SPHERE_RADIUS ** 2)
    z = (-b - np.sqrt(np.maximum(disc, 0.0))) / (2.0 * a)
    return np.where((disc > 0) & (z > 0), z, 0.0).astype(np.float32)


def score_cloud(what: str, xyz: np.ndarray, gt: np.ndarray, card: str):
    """Chamfer of `xyz` against the GT points, timed in its two parts;
    checks that each mean is finite exactly when some distance is below
    max_dist, and returns the result."""
    t0 = time.perf_counter()
    down = eval_geo.downsample_radius(xyz, 0.2)
    down_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ch = {k: float("nan") for k in ("acc", "comp", "overall")}
    near = {"acc": 0.0, "comp": 0.0}
    if xyz.shape[0]:
        ch = eval_geo.chamfer(down, gt, downsample=0.0, want_detail=True)
        detail = ch.pop("detail")
        for k, dist in (("acc", detail["d2s"]), ("comp", detail["s2d"])):
            inside = dist < detail["max_dist"]
            near[k] = float(inside.mean())
            _check(bool(np.isfinite(ch[k])) == bool(inside.any()),
                   f"chamfer {k} {ch[k]} with {int(inside.sum())} "
                   f"distances below {detail['max_dist']}")
    nn_s = time.perf_counter() - t0
    print(f"[eval] {what}: chamfer vs {gt.shape[0]} points on the sphere "
          f"(radius {SPHERE_RADIUS}): acc {ch['acc']:.4f}, comp "
          f"{ch['comp']:.4f}, overall {ch['overall']:.4f} (distances below "
          f"20: {near['acc']:.3f} of the cloud, {near['comp']:.3f} of the "
          f"sphere's points); downsampling {xyz.shape[0]} -> "
          f"{down.shape[0]} points {down_s:.3f} s, NN queries {nn_s:.3f} s "
          f"[{card}]", flush=True)
    return ch


def small_run_args(tmp: str, outdir: str):
    """cli.run's arguments for the 64x96 fixture under tmp/small."""
    small = os.path.join(tmp, "small")
    return [f"testlist={SCAN}", f"outdir={outdir}", f"data_dir_root={small}",
            f"dataset.data_dir_root={small}", f"max_h={SMALL_RES[0]}",
            f"max_w={SMALL_RES[1]}",
            f"dataset.img_res=[{SMALL_RES[0]},{SMALL_RES[1]}]",
            f"mvs.ndepths={list(SMALL_NDEPTHS)}",
            f"mvs.numdepth={SMALL_NDEPTHS[0]}", "mvs.x2_mvsres=false"]


def run_fusion(dev, card: str, tmp: str, res, data_root: str) -> Dict:
    """Phase 7 (see the module docstring) on phase 6's outputs; returns
    the kernel's numbers and the launches of both kernels on this
    slice's path ((b) and (d))."""
    cfg = dtu_config()
    fdist, fdiff = cfg.filter.filter_dist, cfg.filter.filter_diff
    scan_dir = os.path.join(res["outdir"], SCAN)
    trains_i = res["trainer"].trains_i

    # (a) The kernel against its plain version on the scene's own pairs.
    views, _ = load_views(scan_dir, scan_dir, trains_i, device=dev)
    depths = [torch.as_tensor(v["depth"], device=dev) for v in views]
    H, W = depths[0].shape
    mask_diff, depth_err, xy_err, kept = 0, 0.0, 0.0, []
    for i, j in permutations(range(len(views)), 2):
        mats = geo_consistency.pair_matrices(
            views[i]["intrinsics"], views[i]["extrinsics"],
            views[j]["intrinsics"], views[j]["extrinsics"])
        got = geo_consistency.geo_consistency(depths[i], depths[j], mats,
                                              fdist, fdiff, xy=True)
        ref = geo_consistency.geo_consistency_plain(depths[i], depths[j], mats,
                                                    fdist, fdiff, xy=True)
        mask_diff += int((got[0] != ref[0]).sum())
        depth_err = max(depth_err, (got[1] - ref[1]).abs().max().item())
        xy_err = max(xy_err, (got[2] - ref[2]).abs().max().item(),
                     (got[3] - ref[3]).abs().max().item())
        kept.append(got[0].float().mean().item())
    _check(mask_diff == 0 and depth_err <= FUSION_DEPTH_TOL
           and xy_err <= FUSION_XY_TOL,
           f"geo_consistency vs plain: {mask_diff} mask pixels differ, depth "
           f"{depth_err}, x/y {xy_err}")
    mats = geo_consistency.pair_matrices(
        views[0]["intrinsics"], views[0]["extrinsics"],
        views[1]["intrinsics"], views[1]["extrinsics"])

    def kernel():
        return geo_consistency.geo_consistency(depths[0], depths[1], mats,
                                               fdist, fdiff)

    kernel_ms = _median_ms(kernel, backlog=True)
    wrapper_ms = _median_ms(kernel)
    plain_ms = _median_ms(lambda: geo_consistency.geo_consistency_plain(
        depths[0], depths[1], mats, fdist, fdiff), backlog=True)
    # The bound: the larger of the bytes' time and the FP64 instructions'
    # (the kernel's straight-line count in its SASS, one thread a pixel)
    # at the SM clock's maximum, read now.
    nbytes = geo_consistency.io_bytes(H, W)
    bytes_ms = nbytes / (HBM_TBPS * 1e12) * 1e3
    fp64 = fp64_instructions(geo_consistency.build())
    clock_mhz = _sm_clock_mhz()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    ops_ms = fp64["main"] * H * W / (sms * FP64_PER_SM_CLOCK
                                     * clock_mhz * 1e6) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
    print(f"[fusion] geo_consistency vs plain on the card, {len(kept)} "
          f"ordered pairs of {H}x{W} depth maps: mask pixels differing "
          f"{mask_diff}, depth max|diff| {depth_err:.3e} (tol "
          f"{FUSION_DEPTH_TOL}), x/y max|diff| {xy_err:.3e} (tol "
          f"{FUSION_XY_TOL}); consistent pixels "
          + ", ".join(f"{k:.3f}" for k in kept), flush=True)
    print(f"[fusion] geo_consistency FP64-pipe instructions per pixel "
          f"(cuobjdump -sass, straight line): {fp64['main']} "
          f"{fp64['by_opcode']}; {fp64['subroutines']} more in the "
          f"division and square-root slow paths; SM clock max "
          f"{clock_mhz:.0f} MHz, {sms} SMs", flush=True)
    print(f"[fusion] one pair: kernel {kernel_ms:.4f} ms (device, median of "
          f"20), wrapper {wrapper_ms:.4f} ms (host and device), bound "
          f"{bound_ms:.4f} ms by {bound_by} (bytes {bytes_ms:.4f} ms: "
          f"{nbytes} at {HBM_TBPS} TB/s; operations {ops_ms:.4f} ms: "
          f"{fp64['main']} x {H * W} FP64 instructions at {sms} x "
          f"{FP64_PER_SM_CLOCK} a clock): {100 * bound_ms / kernel_ms:.1f}% "
          f"of bound; plain {plain_ms:.3f} ms [{card}]", flush=True)
    # The reference cloud for (c), fused before this slice's path is
    # counted: the same cameras and confidences with the sphere's own
    # depths.
    for view in views:
        view["depth"] = sphere_depth(view["intrinsics"], view["extrinsics"],
                                     view["depth"].shape)
    txyz, _, _ = fuse_views(views, device=dev)
    del views, depths

    # (b) The command line, fusion only, on phase 6's output directory.
    mask_dir = write_train_eval_masks(data_root)
    geo_consistency.geo_consistency.launches = 0   # this slice's path starts
    fused_sdf.reset_launches()
    cost_mapping.reset_launches()
    t0 = time.perf_counter()
    plys = cli_run.main([f"outdir={res['outdir']}", f"testlist={SCAN}",
                         f"data_dir_root={data_root}", "filter_only=true"])
    fusion_s = time.perf_counter() - t0
    parts = dict(filter_depth.last_seconds)
    xyz, rgb = load_ply(plys[0])
    t0 = time.perf_counter()
    cviews, cmasks = load_views(scan_dir, scan_dir, trains_i,
                                eval_mask_dir=mask_dir, device="cpu")
    cxyz, crgb, stats = fuse_views(cviews, eval_masks=cmasks, device="cpu")
    cpu_s = time.perf_counter() - t0
    _check(xyz.shape == cxyz.shape
           and bool(np.all(np.abs(xyz - cxyz) <= np.spacing(np.abs(cxyz))))
           and np.array_equal(rgb, crgb),
           f"fused cloud card vs CPU: {xyz.shape} vs {cxyz.shape}")
    n_pairs = len(trains_i) * (len(trains_i) - 1)
    print(f"[fusion] cli.run filter_only {SCAN}: {fusion_s:.3f} s (read "
          f"{parts['read']:.3f}, fuse {parts['fuse']:.3f}, PLY write "
          f"{parts['write']:.3f}); the kernel {n_pairs} x {kernel_ms:.4f} ms "
          f"= {100 * n_pairs * kernel_ms / 1e3 / parts['fuse']:.2f}% of the "
          f"fuse; {xyz.shape[0]} points (final masks "
          + ", ".join(f"{st['final']:.3f}" for st in stats)
          + f"); equal to the CPU's fuse_views ({cpu_s:.2f} s) [{card}]",
          flush=True)

    # (c) Chamfer against the fixture's sphere: of the command line's
    # cloud (random weights need not put it on the sphere), and of the
    # cloud that the same cameras fuse from the sphere's own depths,
    # which must lie on it.
    gt = sphere_points(GT_POINTS)
    score_cloud("the fused cloud", xyz, gt, card)
    ch = score_cloud("the fused cloud of the sphere's depths", txyz, gt, card)
    _check(txyz.shape[0] > 0 and ch["acc"] < TRUTH_ACC_TOL
           and np.isfinite(ch["comp"]),
           f"the sphere's own depths fused off the sphere: {ch}, "
           f"{txyz.shape[0]} points")

    # (d) The command line end to end at 64x96 on the card, with no
    # precision override (the JAX defaults).
    out = os.path.join(tmp, "small_exps")
    t0 = time.perf_counter()
    plys = cli_run.main(small_run_args(tmp, out) + [
        f"exps_folder={os.path.join(tmp, SMALL_VSDF)}",
        f"opt_stepNs=[{SMALL_CLI_STEPS},0,0]"])
    torch.cuda.synchronize()
    small_s = time.perf_counter() - t0
    geo_launches = geo_consistency.geo_consistency.launches
    sdf_launches = dict(fused_sdf.fused_sdf_values.mode_launches)
    cost_launches = cost_mapping.cost_mapping.launches   # ... and ends here
    for v in trains_i:
        for name in (f"depth_est/{v:08d}.pfm", f"depth_est/{v:08d}.png",
                     f"confidence/{v:08d}_final.png", f"images/{v:08d}.png"):
            path = os.path.join(out, SCAN, name)
            _check(os.path.isfile(path), f"missing {path}")
    _check(os.path.isfile(plys[0]), f"missing {plys[0]}")
    _check(geo_launches == 2 * n_pairs
           and sdf_launches["bfloat16"] == SMALL_CLI_STEPS
           and sdf_launches["float32"] > 0
           and cost_launches == SMALL_CLI_STEPS,
           f"launches on the command-line path: geo_consistency "
           f"{geo_launches}, fused SDF {sdf_launches}, cost_mapping "
           f"{cost_launches}")
    print(f"[fusion] cli.run end to end {SCAN} at {SMALL_RES[0]}x"
          f"{SMALL_RES[1]}, {SMALL_CLI_STEPS} steps, no precision override: "
          f"{small_s:.2f} s, {load_ply(plys[0])[0].shape[0]} points; launches "
          f"on the command-line path: geo_consistency {geo_launches}, fused "
          f"SDF {sdf_launches}, cost_mapping {cost_launches} [{card}]",
          flush=True)
    return {"launches": geo_launches, "sdf_launches": sdf_launches,
            "cost_launches": cost_launches,
            "max_abs_err": max(depth_err, xy_err), "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "fp64_instructions": fp64["main"], "sm_clock_mhz": clock_mhz,
            "wrapper_ms": wrapper_ms}


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


def _median_ms(fn, reps: int = 20, backlog: bool = False) -> float:
    """Median of `reps` timings of fn by CUDA events. With `backlog`,
    each behind a queued device sleep, so the device time of fn's
    kernels is measured and not its host time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if backlog:
            torch.cuda._sleep(BACKLOG_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def bf16_errors(got, ref):
    """The bfloat16 mode against its plain version: (max, mean) of
    |got - ref| / (|ref| + 1)."""
    rel = (got - ref).abs() / (ref.abs() + 1)
    return rel.max().item(), rel.mean().item()


def _bf16_units(a, b):
    """|a - b| in bf16 units of bf16-valued float32 tensors of one sign
    (their float32 bits' distance, over 2^16)."""
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    return (ia - ib).abs() >> 16


def check_act_bf16(dev, raise_past_bar: bool = True) -> Dict:
    """The bfloat16 mode's activation over every finite bf16 input h:
    the kernel's own (`fused_sdf.act_bf16_values`) against
    `softplus_b` on a bf16 tensor on the card (torch rounds each op to
    bf16) and, for scale, the softplus rounded once. Counts the inputs
    where they differ and either result is a normal float, and the most
    bf16 units apart; raises past ACT_MISMATCHES."""
    h = torch.from_numpy((np.arange(1 << 16, dtype=np.uint32) << 16)
                         .view(np.float32))
    h = h[torch.isfinite(h)].to(dev)
    got = fused_sdf.act_bf16_values(h)
    want = softplus_b(h.to(torch.bfloat16), beta=100.0).float()
    once = fused_sdf.bf16r(softplus_b(fused_sdf.bf16r(h), beta=100.0))
    tiny = torch.finfo(torch.float32).tiny
    out = {"inputs": h.numel()}
    for name, other in (("kernel", got), ("round_once", once)):
        normal = torch.maximum(other.abs(), want.abs()) >= tiny
        off = (other != want) & normal
        out[f"{name}_mismatches"] = int(off.sum())
        out[f"{name}_max_units"] = int(_bf16_units(other[off], want[off]).max()
                                       ) if bool(off.any()) else 0
    if raise_past_bar:
        _check(out["kernel_mismatches"] <= ACT_MISMATCHES,
               f"bf16 activation over every bf16 input: {out}, bar "
               f"{ACT_MISMATCHES} inputs apart")
    return out


def _bf16_within(got, ref) -> float:
    """The bfloat16 mode's check against its plain version: raises past
    BF16_KERNEL_UNITS (|ref| + 1); returns max |got - ref|."""
    err = (got - ref).abs()
    worst = (err / (ref.abs() + 1)).max().item()
    _check(worst <= BF16_KERNEL_UNITS,
           f"bf16 kernel vs plain: {worst} (|sdf| + 1) > {BF16_KERNEL_UNITS}")
    return err.max().item()


def check_fused_sdf(dev, card: str) -> Dict:
    """Phase 3, the fused SDF kernel in both modes (see the module
    docstring); returns each mode's numbers."""
    cfg = dtu_config()
    models = {"float32": cfg.model, "bfloat16": training_model_config(cfg)}
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                dev)
    flop = sdf_flops_per_point(params.sdf)
    out = {}
    for mode, mcfg in models.items():
        _check(fused_sdf.mode(mcfg) == mode, f"mode of {mcfg}")
        errs, means = {}, {}
        for n in (KERNEL_SWEEP, 700, KERNEL_RENDER):
            pts = torch.as_tensor(np.random.default_rng(1).normal(
                size=(n, 3)).astype(np.float32), device=dev)
            got = fused_sdf.fused_sdf_values(params.sdf, mcfg, pts, 3.0)
            ref = fused_sdf.sdf_values_plain(params.sdf, mcfg, pts, 3.0)
            torch.cuda.synchronize()
            if mode == "float32":
                errs[n] = torch.max(torch.abs(got - ref)).item()
                _check(errs[n] <= KERNEL_TOL, f"kernel vs plain at {n} "
                       f"points: {errs[n]} > {KERNEL_TOL}")
            else:
                errs[n] = _bf16_within(got, ref)
                if n >= KERNEL_SWEEP:
                    means[n] = bf16_errors(got, ref)[1]
                    _check(means[n] <= BF16_KERNEL_MEAN,
                           f"bf16 kernel vs plain at {n} points: mean "
                           f"{means[n]} (|sdf| + 1) > {BF16_KERNEL_MEAN}")
            del got, ref
        t0 = time.perf_counter()
        pack = fused_sdf.pack_sdf(params.sdf, mcfg)
        torch.cuda.synchronize()
        pack_ms = 1e3 * (time.perf_counter() - t0)
        products = 3 if mode == "float32" else 1
        kernel_ms, bound_ms = {}, {}
        for n in (KERNEL_SWEEP, KERNEL_RENDER):
            pts = torch.as_tensor(np.random.default_rng(1).normal(
                size=(n, 3)).astype(np.float32), device=dev)
            kernel_ms[n] = _median_ms(lambda: fused_sdf.fused_sdf_values(
                params.sdf, mcfg, pts, 3.0, pack=pack))
            bound_ms[n] = products * n * flop / (BF16_TFLOPS * 1e12) * 1e3
            if n == KERNEL_SWEEP:
                plain_ms = _median_ms(lambda: fused_sdf.sdf_values_plain(
                    params.sdf, mcfg, pts, 3.0))
        tflops = {n: n * flop / (ms * 1e-3) / 1e12
                  for n, ms in kernel_ms.items()}
        tol = (f"tol {KERNEL_TOL}" if mode == "float32" else
               f"tol {BF16_KERNEL_UNITS} (|sdf| + 1)")
        print(f"[kernel] fused_sdf {mode} mode vs plain: max|diff| "
              f"{errs[KERNEL_SWEEP]:.3e} at {KERNEL_SWEEP} pts, "
              f"{errs[700]:.3e} at 700 pts, {errs[KERNEL_RENDER]:.3e} at "
              f"{KERNEL_RENDER} pts ({tol}) [{card}]", flush=True)
        for n in (KERNEL_SWEEP, KERNEL_RENDER):
            print(f"[kernel] fused_sdf {mode} mode, {n} pts: kernel "
                  f"{kernel_ms[n]:.4f} ms (median of 20), {tflops[n]:.1f} "
                  f"TFLOP/s, bound {bound_ms[n]:.4f} ms ({products} bf16 "
                  f"product{'s' if products > 1 else ''} at "
                  f"{BF16_TFLOPS:.0f} TFLOP/s): "
                  f"{100 * bound_ms[n] / kernel_ms[n]:.1f}% of bound"
                  + (f"; plain {plain_ms:.3f} ms" if n == KERNEL_SWEEP
                     else "") + f" [{card}]", flush=True)
        if mode == "bfloat16":
            act = check_act_bf16(dev)
            print(f"[kernel] fused_sdf bfloat16 mode vs plain: mean "
                  f"|diff| / (|sdf| + 1) "
                  + ", ".join(f"{v:.3e} at {n} pts" for n, v in means.items())
                  + f" (tol {BF16_KERNEL_MEAN}); its activation over every "
                  f"bf16 input against torch's bf16 ops: {act} (tol "
                  f"{ACT_MISMATCHES} inputs apart) [{card}]",
                  flush=True)
        print(f"[kernel] pack_sdf {mode} mode (weight norm, layout) "
              f"{pack_ms:.2f} ms [{card}]", flush=True)
        out[mode] = {"errs": errs, "means": means, "kernel_ms": kernel_ms,
                     "bound_ms": bound_ms, "plain_ms": plain_ms,
                     "tflops": tflops}
        del pack
    return out


def cost_mapping_samples(scene, view: int, device) -> torch.Tensor:
    """xyz (COST_RAYS, COST_SAMPLES, 3) along rays of `view` through
    pixels a little past the image, at sorted depths in [0.3, 5.5]:
    inside and outside the hypothesis slab, in front of and behind some
    of the cameras (`tools.time_cost_mapping.samples`, seed 11 + view)."""
    return samples(scene, view, device, 11 + view)


def check_cost_mapping(dev, card: str) -> Dict:
    """Phase 3, the cost-mapping kernel (see the module docstring);
    returns its numbers for the bf16 volumes (the default), with the
    float32 volumes' beside them."""
    scene = make_sphere_scene(3, CASCADE_RES)
    f32 = make_volumes(scene, BENCH_VOLUMES, dev)
    sets = sample_sets(scene, dev)
    # The cold timing's own floor: an empty kernel timed the same way.
    floor_ms = float(np.median(cold_ms([lambda: torch.cuda._sleep(0)]
                                       * len(sets))))
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        err, masks, valid = 0.0, 0, []
        for view in (0, 2):
            xyz = cost_mapping_samples(scene, view, dev)
            onehot = torch.zeros(3, device=dev)
            onehot[view] = 1.0
            for inverse in (False, True):
                mvs = cost_mapping.check_volumes(dataclasses.replace(
                    f32, prob=f32.prob.to(dtype), inverse_depth=inverse))
                got = cost_mapping.cost_mapping(None, xyz, onehot, mvs)
                ref = cost_mapping.cost_mapping_plain(xyz, onehot, mvs)
                torch.cuda.synchronize()
                masks += int((got[2] != ref[2]).sum())
                err = max(err, (got[0] - ref[0]).abs().max().item(),
                          (got[1] - ref[1]).abs().max().item())
                valid.append(ref[2].float().mean().item())
        _check(masks == 0 and err <= COST_TOL,
               f"cost_mapping vs plain ({dtype}): {masks} mask samples "
               f"differ, pj/pi {err} > {COST_TOL}")
        mvs = dataclasses.replace(f32, prob=f32.prob.to(dtype))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mvs = cost_mapping.check_volumes(mvs)
        torch.cuda.synchronize()
        pack_ms = (time.perf_counter() - t0) * 1e3
        xyz = cost_mapping_samples(scene, 0, dev)
        onehot = torch.tensor([1.0, 0.0, 0.0], device=dev)
        warm_ms = _median_ms(lambda: cost_mapping.cost_mapping(
            None, xyz, onehot, mvs), backlog=True)
        cold = cold_ms([lambda x=x, o=o: cost_mapping.cost_mapping(
            None, x, o, mvs) for x, o in sets])
        kernel_ms = float(np.median(cold))
        wrapper_ms = _median_ms(lambda: cost_mapping.cost_mapping(
            None, xyz, onehot, mvs))
        plain_ms = _median_ms(lambda: cost_mapping.cost_mapping_plain(
            xyz, onehot, mvs), backlog=True)
        # The bound counts the layout the kernel reads (the smaller of
        # the corner-block copies' sectors and the unpacked volumes').
        unpacked = [cost_mapping.touched_bytes(x, mvs) for x, _ in sets]
        nbytes = [min(cost_mapping.packed_bytes(x, mvs), u)
                  for (x, _), u in zip(sets, unpacked)]
        bound_ms = float(np.median(nbytes)) / (HBM_TBPS * 1e12) * 1e3
        unpacked_ms = float(np.median(unpacked)) / (HBM_TBPS * 1e12) * 1e3
        name = str(dtype).replace("torch.", "")
        print(f"[kernel] cost_mapping {name} volumes vs plain, {COST_RAYS}x"
              f"{COST_SAMPLES} samples x 3 views of {BENCH_VOLUMES}, linear "
              f"and inverse depth, views 0 and 2: mask samples differing "
              f"{masks}, pj/pi max|diff| {err:.3e} (bit-equal required); "
              f"valid {min(valid):.3f}-{max(valid):.3f} of the samples",
              flush=True)
        print(f"[kernel] cost_mapping {name} volumes: kernel cold "
              f"{kernel_ms:.4f} ms (device, median over {len(sets)} sample "
              f"sets, each behind a queued sleep and a 256 MB scratch write; "
              f"{min(cold):.4f}-{max(cold):.4f}), "
              f"warm {warm_ms:.4f} ms (one set 20 times, in L2), wrapper "
              f"{wrapper_ms:.4f} ms (host and device); bound "
              f"{bound_ms:.4f} ms (median of the sets' "
              f"{int(np.median(nbytes))} bytes: distinct 32-byte sectors "
              f"of the corner-block copies read and the samples' I/O, at "
              f"{HBM_TBPS} TB/s; the unpacked volumes' {unpacked_ms:.4f} ms): "
              f"{100 * bound_ms / kernel_ms:.1f}% of bound cold, "
              f"{100 * bound_ms / warm_ms:.1f}% warm; the cold timing's "
              f"floor (an empty kernel) {floor_ms:.4f} ms, the kernel's "
              f"cold time past it {kernel_ms - floor_ms:.4f} ms; plain "
              f"{plain_ms:.3f} ms; the corner-block copy made in "
              f"{pack_ms:.2f} ms (host clock) [{card}]", flush=True)
        out[name] = {"max_abs_err": err, "ms_cold": kernel_ms,
                     "ms_warm": warm_ms, "wrapper_ms": wrapper_ms,
                     "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bytes_unpacked_ms": unpacked_ms, "pack_ms": pack_ms,
                     "floor_ms": floor_ms}
    return out


def run_training(dev, card: str, exps_root: str):
    """Phases 4 and 5 (see the module docstring), the main path: the
    launch counts are set to 0 before the first step and read after the
    last render. Returns the trainers ({"defaults", "float32"}; the
    float32 one with its run directory under exps_root) and the
    launches."""
    trainers = {}
    t0 = time.perf_counter()
    for what, cfg in (("defaults", dtu_config()),
                      ("float32", float32_dtu_config())):
        trainers[what] = make_trainer(
            cfg, (cfg.max_h, cfg.max_w), BENCH_VOLUMES, dev,
            exps_root if what == "float32" else None)
    torch.cuda.synchronize()
    print(f"[train] two scenes + volumes set up in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    fused_sdf.reset_launches()                  # the main path starts here
    cost_mapping.reset_launches()
    for what, trainer in trainers.items():
        before = dict(fused_sdf.fused_sdf_values.mode_launches)
        cost_before = cost_mapping.cost_mapping.launches
        trainer.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        modes = {m: n - before[m]
                 for m, n in fused_sdf.fused_sdf_values.mode_launches.items()}
        costs = cost_mapping.cost_mapping.launches - cost_before
        losses = [lo.loss for lo in trainer.losses]
        finite = [lo.grad_finite for lo in trainer.losses]
        _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
               f"{what}: finite losses: {losses}")
        _check(all(f == 1.0 for f in finite),
               f"{what}: grad_finite every step: {finite}")
        mode = "bfloat16" if what == "defaults" else "float32"
        _check(modes[mode] == TRAIN_STEPS and sum(modes.values()) == TRAIN_STEPS
               and costs == TRAIN_STEPS,
               f"{what}: launches in training: fused SDF {modes}, "
               f"cost_mapping {costs}")
        step_ms = 1e3 * float(np.median(trainer.chunk_seconds))
        print(f"[train] {what}: {TRAIN_STEPS} steps: loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, median {step_ms:.2f} ms/step, "
              f"{trainer.cfg.train.num_pixels / (step_ms / 1e3):.1f} rays/s, "
              f"fused SDF launches {modes}, cost_mapping launches {costs} "
              f"[{card}]", flush=True)

    # 5. Feedback renders of view 0 at full resolution, both precisions.
    trainer = trainers["defaults"]
    H, W = trainer.scene.img_res
    render_seconds = {}
    for dtype in ("float32", "bfloat16"):
        trainer.cfg.train.feedback_render_dtype = dtype
        builds = fused_sdf.pack_sdf.builds
        before = dict(fused_sdf.fused_sdf_values.mode_launches)
        t0 = time.perf_counter()
        depth = trainer.render_mvs(0)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        modes = {m: n - before[m]
                 for m, n in fused_sdf.fused_sdf_values.mode_launches.items()}
        _check(fused_sdf.pack_sdf.builds == builds + 1,
               f"packs built in one render: {fused_sdf.pack_sdf.builds - builds}")
        _check(depth.shape == (H, W) and bool(np.isfinite(depth).all()),
               f"render {dtype}: shape {depth.shape}, finite "
               f"{np.isfinite(depth).all()}")
        _check(modes[dtype] > 0 and sum(modes.values()) == modes[dtype],
               f"render {dtype}: kernel launches {modes}")
        print(f"[render] render_mvs {H}x{W} fast=-1, feedback_render_dtype "
              f"{dtype}: {render_s:.3f} s, depth {depth.min():.4f}.."
              f"{depth.max():.4f}, kernel launches {modes[dtype]} [{card}]",
              flush=True)
        render_seconds[dtype] = render_s
    print(f"[render] feedback render {H}x{W}, s/view: float32 "
          f"{render_seconds['float32']:.3f}, bfloat16 "
          f"{render_seconds['bfloat16']:.3f} [{card}]", flush=True)
    trainer.cfg.train.feedback_render_dtype = "float32"
    launches = {"fused_sdf": dict(fused_sdf.fused_sdf_values.mode_launches),
                "cost_mapping": cost_mapping.cost_mapping.launches}
    print(f"[train] launches on the training and render path: {launches}",
          flush=True)                           # the main path ends here
    return trainers, launches


def outside_family_config(**implicit) -> Config:
    """The dtu preset at the JAX defaults with an SDF MLP outside the
    fused kernel's family (fields of model.implicit replaced)."""
    cfg = dtu_config()
    for name, value in implicit.items():
        setattr(cfg.model.implicit, name, value)
    return cfg


def run_outside_family(dev, card: str, base: VolTrainer) -> Dict:
    """Phase 4, continued: OUTSIDE_STEPS steps and a 6x8 render of view 0
    with each SDF MLP of OUTSIDE_FAMILY, on `base`'s scene and volumes.
    The sampler takes the plain route (`network.sampler_sdf_fn`): the
    launch counts, set to 0 before and read after, show no fused-SDF
    launch and no pack, the plain sweeps rising, and one cost-mapping
    launch a step. Returns the launches."""
    fused_sdf.reset_launches()                  # this path starts
    cost_mapping.reset_launches()
    builds = fused_sdf.pack_sdf.builds
    scene = base.scene
    intr = np.array(scene.intrinsics[0], np.float32)
    intr[:2] *= 8 / scene.img_res[1]
    for what, implicit in OUTSIDE_FAMILY.items():
        cfg = outside_family_config(**implicit)
        _check(not fused_sdf.supported(cfg.model),
               f"{what}: inside the kernel's family")
        trainer = VolTrainer(cfg, scene, device=dev, chunk_steps=1)
        trainer.mvs = base.mvs
        sweeps = fused_sdf.plain_sweeps
        trainer.run(OUTSIDE_STEPS)
        torch.cuda.synchronize()
        step_sweeps = fused_sdf.plain_sweeps - sweeps
        losses = [lo.loss for lo in trainer.losses]
        _check(len(losses) == OUTSIDE_STEPS and all(np.isfinite(losses))
               and all(lo.grad_finite == 1.0 for lo in trainer.losses),
               f"{what}: finite losses and gradients: {trainer.losses}")
        sweeps = fused_sdf.plain_sweeps
        t0 = time.perf_counter()
        maps = render_depth(trainer.state.params, cfg.model, scene.poses[0],
                            intr, (6, 8), chunk=48)
        render_s = time.perf_counter() - t0
        render_sweeps = fused_sdf.plain_sweeps - sweeps
        _check(all(np.isfinite(m).all() for m in maps.values())
               and step_sweeps > 0 and render_sweeps > 0,
               f"{what}: render finite, plain sweeps {step_sweeps} in "
               f"training, {render_sweeps} in the render")
        print(f"[train] outside the fused kernel's family, {what}: "
              f"{OUTSIDE_STEPS} steps, loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, median "
              f"{1e3 * float(np.median(trainer.chunk_seconds)):.2f} ms/step, "
              f"plain sweeps {step_sweeps}; 6x8 render {render_s:.3f} s, "
              f"plain sweeps {render_sweeps}, depth "
              f"{maps['depth'].min():.4f}..{maps['depth'].max():.4f} "
              f"[{card}]", flush=True)
        del trainer
    launches = {"fused_sdf": dict(fused_sdf.fused_sdf_values.mode_launches),
                "cost_mapping": cost_mapping.cost_mapping.launches}
    packs = fused_sdf.pack_sdf.builds - builds   # ... and ends here
    _check(sum(launches["fused_sdf"].values()) == 0 and packs == 0
           and launches["cost_mapping"] == OUTSIDE_STEPS * len(OUTSIDE_FAMILY),
           f"launches outside the family: {launches}, packs {packs}")
    print(f"[train] launches on the out-of-family path: {launches}, weight "
          f"packs {packs}", flush=True)
    return launches


def check_render_on_cpu(trainer) -> None:
    """Phase 5: the trained field rendered on the card (kernel) and on the
    CPU (plain path) agree on a small view."""
    scene, cfg = trainer.scene, trainer.cfg
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


def check_near_surface(trainer) -> Dict[str, float]:
    """Phase 3, continued: the fused kernel on the trained field's own
    rays nearest its surface, where the sampler's choices are most
    sensitive, in both modes; returns each mode's max |diff|."""
    near, near_sdf = near_surface_points(trainer)
    bs = trainer.cfg.model.scene_bounding_sphere
    sdf = trainer.state.params.sdf
    errs = {}
    bf16 = dataclasses.replace(trainer.cfg.model, compute_dtype="bfloat16",
                               activation_dtype="bfloat16")
    for mode, mcfg in (("float32", trainer.cfg.model), ("bfloat16", bf16)):
        got = fused_sdf.fused_sdf_values(sdf, mcfg, near, bs)
        ref = fused_sdf.sdf_values_plain(sdf, mcfg, near, bs)
        torch.cuda.synchronize()
        if mode == "float32":
            errs[mode] = torch.max(torch.abs(got - ref)).item()
            _check(errs[mode] <= KERNEL_TOL,
                   f"kernel vs plain near the trained surface: "
                   f"{errs[mode]} > {KERNEL_TOL}")
        else:
            errs[mode] = _bf16_within(got, ref)
    print(f"[kernel] trained field, {near.shape[0]} sampler points of view 0 "
          f"with |sdf| <= {near_sdf:.3e}: kernel vs plain max|diff| "
          f"{errs['float32']:.3e} float32 mode (tol {KERNEL_TOL}), "
          f"{errs['bfloat16']:.3e} bfloat16 mode (tol {BF16_KERNEL_UNITS} "
          f"(|sdf| + 1))", flush=True)
    return errs


# --------------------------------------------------------------------------
# 8. Evaluation
# --------------------------------------------------------------------------

EVAL_RES = 512            # mesh export's grid (the eval command line's default)
# The bbs.npz export's grid: its host side (marching tetrahedra, the
# largest component) took 30 s at 512^3 on an NVIDIA H100 80GB HBM3
# machine (700 W), which the 512^3 export over plot.grid_boundary
# already shows.
EVAL_BOX_RES = 256
EVAL_SUBGRID = 64         # the kernel held to the plain MLP on a 64^3 sub-grid
EVAL_VERTS = 65536        # mesh vertices checked against the plain MLP
EVAL_CLI_RES = 64         # the command line's mesh grid at 64x96
ROUND_TRIP_STEPS = 3
# The fixture's bbs.npz box for mesh export (scan106; scaled by [1.5, 1.0]
# as in the JAX package), in the trainer's units: around the sphere.
EVAL_BOX = np.array([[-1.0, -1.0, -1.0], [1.0, 1.0, 1.0]])


def _rss_gb() -> float:
    """The process's resident memory now, in GB (/proc/self/status)."""
    with open("/proc/self/status") as f:
        line = next(x for x in f if x.startswith("VmRSS:"))
    return int(line.split()[1]) / 2 ** 20


class RssPeak:
    """The largest resident memory of the process seen while the block
    runs, sampled every 10 ms by a thread (the card's machine does not
    let a process reset its own peak): `before` and `peak`, in GB."""

    def __enter__(self):
        self.before = self.peak = _rss_gb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.01):
            self.peak = max(self.peak, _rss_gb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, _rss_gb())


def _launch_counts() -> Dict:
    """Every kernel's launches since `_reset_counts`."""
    return {"fused_sdf": dict(fused_sdf.fused_sdf_values.mode_launches),
            "cost_mapping": cost_mapping.cost_mapping.launches,
            "deform_conv": deform_conv.deform_conv2d.launches,
            "geo_consistency": geo_consistency.geo_consistency.launches,
            "fused_sdf_scenes": dict(fused_sdf.fused_sdf_values.scene_launches),
            "cost_mapping_scenes": dict(
                cost_mapping.cost_mapping.scene_launches)}


def _reset_counts() -> None:
    fused_sdf.reset_launches()
    cost_mapping.reset_launches()
    deform_conv.deform_conv2d.launches = 0
    geo_consistency.geo_consistency.launches = 0


def eval_round_trip(dev, card: str, trainer: VolTrainer, exps_root: str):
    """Phase 8(a): save the trained float32 trainer, load it into a fresh
    VolTrainer(is_continue=True), hold every leaf and the generator
    bit-equal, then ROUND_TRIP_STEPS more steps on each bit-equal."""
    t0 = time.perf_counter()
    path = trainer.save_checkpoint()
    save_ms = 1e3 * (time.perf_counter() - t0)
    fresh = VolTrainer(trainer.cfg, trainer.scene, SCAN, device=dev,
                       exps_root=exps_root, is_continue=True, chunk_steps=1)
    t0 = time.perf_counter()
    fresh.load_checkpoint()
    torch.cuda.synchronize()
    load_ms = 1e3 * (time.perf_counter() - t0)
    _check(fresh.checkpoints_path == trainer.checkpoints_path,
           f"resumed run directory {fresh.rundir} != {trainer.rundir}")

    def leaves_equal(a, b) -> bool:
        return all(np.array_equal(x, y) for x, y in
                   zip(ckpt.train_state_leaves(a.state),
                       ckpt.train_state_leaves(b.state)))
    _check(leaves_equal(trainer, fresh)
           and torch.equal(trainer.gen.get_state(), fresh.gen.get_state()),
           "checkpoint round trip: leaves or generator state differ")
    fresh.mvs = trainer.mvs
    trainer.run(ROUND_TRIP_STEPS)
    fresh.run(ROUND_TRIP_STEPS)
    torch.cuda.synchronize()
    a = [lo.loss for lo in trainer.losses]
    b = [lo.loss for lo in fresh.losses]
    _check(a == b and leaves_equal(trainer, fresh),
           f"resumed steps differ: losses {a} vs {b}")
    n = len(ckpt.train_state_leaves(trainer.state))
    size = os.path.getsize(os.path.join(path, ckpt.STATE_FILE))
    print(f"[eval] checkpoint round trip at iter_step "
          f"{trainer.state.iter_step - ROUND_TRIP_STEPS}: save {save_ms:.1f} ms"
          f", load {load_ms:.1f} ms ({n} leaves, {size / 2 ** 20:.2f} MiB); "
          f"leaves, Adam and the CUDA generator bit-equal; "
          f"{ROUND_TRIP_STEPS} more steps on each: losses and parameters "
          f"bit-equal ({a[-1]:.6f}) [{card}]", flush=True)
    return {"save_ms": save_ms, "load_ms": load_ms}


def eval_render(dev, card: str, trainer: VolTrainer) -> Dict:
    """Phase 8(b): render_image of view 0 at full resolution, its depth
    against render_depth's, and a 6x8 render_image card vs CPU."""
    scene, mcfg = trainer.scene, trainer.cfg.model
    H, W = scene.img_res
    before = dict(fused_sdf.fused_sdf_values.mode_launches)
    builds = fused_sdf.pack_sdf.builds
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    maps = trainer.render_view(0)
    torch.cuda.synchronize()
    image_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launches = fused_sdf.fused_sdf_values.mode_launches["float32"] \
        - before["float32"]
    _check(all(bool(np.isfinite(m).all()) for m in maps.values())
           and maps["rgb"].shape == (H, W, 3) and launches > 0
           and fused_sdf.pack_sdf.builds == builds + 1,
           f"render_image {H}x{W}: finite maps, {launches} launches, "
           f"{fused_sdf.pack_sdf.builds - builds} packs")
    t0 = time.perf_counter()
    depth = render_depth(trainer.state.params, mcfg, scene.poses[0],
                         scene.intrinsics[0], (H, W), fast=-1)
    torch.cuda.synchronize()
    depth_s = time.perf_counter() - t0
    err = np.abs(maps["depth"] - depth["depth"])
    acc_err = float(np.abs(maps["acc"] - depth["acc"]).max())
    print(f"[eval] render_image {H}x{W} fast=-1, float32: {image_s:.3f} s "
          f"(render_depth of the view {depth_s:.3f} s), fused SDF launches "
          f"{launches}, peak memory {peak:.2f} GiB; rgb "
          f"{maps['rgb'].min():.4f}..{maps['rgb'].max():.4f}, acc "
          f"{maps['acc'].min():.4f}..{maps['acc'].max():.4f} [{card}]",
          flush=True)
    print(f"[eval] render_image depth vs render_depth (same sampler sweeps, "
          f"final SDF from the plain MLP vs the kernel): max|diff| "
          f"{err.max():.3e}, {int((err > RENDER_TOL).sum())} of {err.size} "
          f"pixels past {RENDER_TOL}; acc max|diff| {acc_err:.3e}", flush=True)
    intr = np.array(scene.intrinsics[0], np.float32)
    intr[:2] *= 8 / W
    args = (mcfg, scene.poses[0], intr, (6, 8))
    on_card = render_image(trainer.state.params, *args, chunk=48)
    cpu_params = init_volsdf_params(torch.Generator().manual_seed(0), mcfg,
                                    "cpu")
    cpu_params.load_state_dict(trainer.state.params.state_dict())
    on_cpu = render_image(cpu_params, *args, chunk=48, device="cpu")
    small_err = max(float(np.max(np.abs(on_card[k] - on_cpu[k])))
                    for k in on_card)
    _check(small_err <= RENDER_TOL,
           f"6x8 render_image, card vs CPU plain: {small_err} > {RENDER_TOL}")
    print(f"[eval] 6x8 render_image card vs CPU plain path: max|diff| "
          f"{small_err:.3e} over rgb, depth, normal, acc (tol {RENDER_TOL})",
          flush=True)
    return {"image_s": image_s, "depth_s": depth_s, "peak_gib": peak,
            "launches": launches}


def _print_export(what: str, res: int, st: Dict, total_s: float, rss,
                  card: str) -> None:
    low, high = st["grids"]
    print(f"[eval] export_mesh {what} at {res}^3: {total_s:.2f} s: "
          f"100^3 pass (grid {low['seconds']:.3f} s, {low['launches']} "
          f"launch; marching {st['marching'][0]:.3f} s; largest component "
          f"{st['component'][0]:.3f} s), {res}^3 grid {high['seconds']:.3f}"
          f" s ({high['launches']} launches, "
          f"{1e3 * high['seconds'] / high['launches']:.2f} ms each with the "
          f"points' making and the copy back), marching tetrahedra "
          f"{st['marching'][1]:.3f} s, largest component "
          f"{st['component'][-1]:.3f} s, PLY write {st['write']:.3f} s; "
          f"{st['verts']} vertices, {st['faces']} faces; host RSS "
          f"{rss.before:.2f} GB before, peak {rss.peak:.2f} GB during "
          f"(sampled every 10 ms) [{card}]", flush=True)


def eval_mesh(dev, card: str, trainer: VolTrainer, tmp: str) -> Dict:
    """Phase 8(c): export_mesh on the trained field at EVAL_RES over
    plot.grid_boundary (extract_mesh_high_res) and at EVAL_BOX_RES
    through a bbs.npz (extract_mesh_by_grid); the kernel's grid values
    on a 64^3 sub-grid
    against the plain MLP, the plain SDF at the mesh's vertices, and the
    per-launch grid points against the whole array."""
    cfg, params = trainer.cfg, trainer.state.params
    bs = cfg.model.scene_bounding_sphere
    scene = dataclasses.replace(trainer.scene, scan_id=int(SCAN[4:]))
    bbs = os.path.join(tmp, "bbs.npz")
    np.savez(bbs, **{SCAN: EVAL_BOX})
    out = {}
    for what, bbs_file, res in (("high_res", None, EVAL_RES),
                                ("by_grid", bbs, EVAL_BOX_RES)):
        stats = {}
        ply = os.path.join(tmp, f"mesh_{what}.ply")
        with RssPeak() as rss:
            t0 = time.perf_counter()
            _check(export_mesh(cfg, scene, params, ply, resolution=res,
                               bbs_file=bbs_file, stats=stats) == ply,
                   f"export_mesh {what}: no surface")
            total_s = time.perf_counter() - t0
        _print_export(what, res, stats, total_s, rss, card)
        verts = load_ply(ply)[0]
        pick = np.random.default_rng(0).permutation(len(verts))[:EVAL_VERTS]
        with torch.no_grad():
            sdf = fused_sdf.sdf_values_plain(
                params.sdf, cfg.model, torch.as_tensor(verts[pick], device=dev),
                bs).abs().max().item()
        voxel = stats["voxel"][-1]
        _check(sdf <= voxel, f"{what}: plain |sdf| {sdf} at the mesh's "
               f"vertices > one voxel {voxel}")
        print(f"[eval] {what}: plain MLP at {len(pick)} mesh vertices: "
              f"max |sdf| {sdf:.3e} (one voxel {voxel:.3e})", flush=True)
        out[what] = {"seconds": total_s, "stats": stats}

    sdf_fn = mesh_sdf_fn(params, cfg.model, bs)
    full, _ = mesh_mod._grid_from_bounds([cfg.plot.grid_boundary[0]] * 3,
                                         [cfg.plot.grid_boundary[1]] * 3,
                                         EVAL_RES)
    step = EVAL_RES // EVAL_SUBGRID
    sub = mesh_mod.GridPoints(full.xs[::step], full.ys[::step],
                              full.zs[::step])
    got = mesh_mod.eval_sdf_grid(sdf_fn, sub)
    with torch.no_grad():
        ref = fused_sdf.sdf_values_plain(
            params.sdf, cfg.model,
            torch.as_tensor(sub.block(0, len(sub)), device=dev), bs)
    err = float(np.abs(got - ref.cpu().numpy()).max())
    _check(err <= KERNEL_TOL, f"grid values kernel vs plain: {err}")
    rng = np.random.default_rng(1)
    vecs = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    grid, _ = mesh_mod._grid_from_bounds([-1.0] * 3, [1.0] * 3, 160, vecs,
                                         rng.standard_normal(3))
    whole = grid.block(0, len(grid))
    blocks = np.concatenate([grid.block(i, min(i + mesh_mod.LAUNCH_POINTS,
                                                len(grid)))
                             for i in range(0, len(grid),
                                            mesh_mod.LAUNCH_POINTS)])
    _check(np.array_equal(whole, blocks), "per-launch grid points differ "
           "from the whole grid's")
    print(f"[eval] grid values on a {EVAL_SUBGRID}^3 sub-grid of the "
          f"{EVAL_RES}^3 grid, kernel vs plain: max|diff| {err:.3e} (tol "
          f"{KERNEL_TOL}); per-launch grid points equal the whole 160^3 "
          f"grid's (PCA transform, this machine's BLAS)", flush=True)
    out["subgrid_err"] = err
    return out


def eval_scene_views(dev, card: str, tmp: str, res: Dict) -> Dict:
    """Phase 8(d): two eval views of phase 6's fixture rendered with its
    float32 trainer and written as the eval command line writes them,
    then eval_rendered_views with random LPIPS weights from a
    checkpoint the phase writes."""
    trainer = res["trainer"]
    scene, cfg = trainer.scene, trainer.cfg
    images = os.path.join(tmp, "nvs")
    vids = scene.eval_ids()[:2]
    render_s = []
    for vid in vids:
        t0 = time.perf_counter()
        maps = trainer.render_view(vid)
        write_png(os.path.join(images, f"eval_{vid:03d}.png"),
                  (np.clip(maps["rgb"], 0, 1) * 255).astype(np.uint8))
        render_s.append(time.perf_counter() - t0)
    weights = os.path.join(tmp, "lpips_random")
    ckpt.save_state(weights, lpips_leaves(init_lpips_params(
        np.random.default_rng(0))))
    seconds = []
    m = eval_rendered_views(cfg, scene, images, "default", weights,
                            device=dev, seconds=seconds)
    _check(m["n_views"] == len(vids)
           and all(np.isfinite(m[f"{k}_mean"]) for k in ("psnr", "ssim",
                                                         "lpips"))
           and 0 < m["ssim_mean"] <= 1 and m["lpips_mean"] > 0,
           f"NVS metrics of {vids}: {m}")
    print(f"[eval] eval_rendered_views {SCAN} views {vids} at "
          f"{scene.img_res[0]}x{scene.img_res[1]}: PSNR {m['psnr_mean']:.3f}, "
          f"SSIM {m['ssim_mean']:.4f}, LPIPS (random VGG weights) "
          f"{m['lpips_mean']:.5f}; metrics "
          + ", ".join(f"{x:.3f}" for x in seconds) + " s per view (render "
          + ", ".join(f"{x:.3f}" for x in render_s) + f" s) [{card}]",
          flush=True)
    return {"metric_s": seconds, "render_s": render_s}


def write_sphere_gt(root: str) -> None:
    """An official-DTU layout for scan106 around the fixture's sphere:
    ObsMask106_10.mat observing the whole box, Plane106.mat below it,
    and the GT points of phase 7(c) as stl106_total.ply."""
    import scipy.io
    obs = os.path.join(root, "ObsMask")
    os.makedirs(obs, exist_ok=True)
    lo, hi, res = -1.25 * SPHERE_RADIUS, 1.25 * SPHERE_RADIUS, 4.0
    n = int(np.ceil((hi - lo) / res)) + 1
    scipy.io.savemat(os.path.join(obs, "ObsMask106_10.mat"),
                     {"ObsMask": np.ones((n, n, n), np.uint8),
                      "BB": np.array([[lo] * 3, [hi] * 3]),
                      "Res": np.array([[res]])})
    scipy.io.savemat(os.path.join(obs, "Plane106.mat"),
                     {"P": np.array([[0.0], [0.0], [1.0], [10 * hi]])})
    save_ply(os.path.join(root, "Points", "stl", "stl106_total.ply"),
             sphere_points(GT_POINTS))


def small_eval_args(tmp: str):
    """cli.eval_vsdf's arguments for phase 7(d)'s run at 64x96."""
    return ["--conf", "dtu", "--scan_ids", SCAN[4:], "--exps_folder",
            os.path.join(tmp, SMALL_VSDF), "--evals_folder",
            os.path.join(tmp, SMALL_EVALS), "--data_dir_root",
            os.path.join(tmp, "small"), "--override",
            f"dataset.img_res=[{SMALL_RES[0]},{SMALL_RES[1]}]"]


def eval_command_lines(dev, card: str, tmp: str) -> Dict:
    """Phase 8(e): cli.eval_vsdf on phase 7(d)'s checkpoint at 64x96
    (renders and mesh, then the metrics), then cli.eval_dtu --mode mesh
    of that mesh against the fixture's sphere points."""
    evals = os.path.join(tmp, SMALL_EVALS)
    common = small_eval_args(tmp)
    t0 = time.perf_counter()
    cli_eval_vsdf.main(["--eval_rendering", "--eval_mesh", "--resolution",
                        str(EVAL_CLI_RES)] + common)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    out = os.path.join(evals, f"ours_{SCAN[4:]}")
    images = [d for d in os.listdir(out) if d.startswith("rendering_")]
    _check(len(images) == 1, f"rendering dirs {images}")
    written = os.listdir(os.path.join(out, images[0]))
    n_views = sum(f.startswith("eval_") for f in written)
    mesh_ply = os.path.join(out, "mesh", f"{SCAN}.ply")
    _check(n_views == 28 and os.path.isfile(mesh_ply),
           f"eval_vsdf wrote {n_views} views, mesh {os.path.isfile(mesh_ply)}")
    t0 = time.perf_counter()
    (m,) = cli_eval_vsdf.main(["--eval_rendering", "--result_from",
                               "default"] + common)
    metric_s = time.perf_counter() - t0
    _check(np.isfinite(m["psnr_mean"]) and 0 < m["ssim_mean"] <= 1,
           f"eval_vsdf metrics {m}")
    gt, pred = os.path.join(tmp, "sphere_gt"), os.path.join(tmp, "mesh_eval")
    write_sphere_gt(gt)
    os.makedirs(pred, exist_ok=True)
    os.replace(mesh_ply, os.path.join(pred, f"mvsnet{SCAN[4:]}_l3.ply"))
    t0 = time.perf_counter()
    rows = cli_eval_dtu.main(["--datadir", pred, "--dataset_dir", gt,
                              "--scan", SCAN[4:], "--mode", "mesh"])
    dtu_s = time.perf_counter() - t0
    _check(len(rows) == 1, f"eval_dtu rows {rows}")
    print(f"[eval] cli.eval_vsdf {SCAN} at {SMALL_RES[0]}x{SMALL_RES[1]}: "
          f"{n_views} views rendered and a {EVAL_CLI_RES}^3 mesh in "
          f"{render_s:.2f} s; --result_from default {metric_s:.2f} s: PSNR "
          f"{m['psnr_mean']:.3f}, SSIM {m['ssim_mean']:.4f} over "
          f"{m['n_views']} views; cli.eval_dtu --mode mesh {dtu_s:.2f} s: acc "
          f"{rows[0][0]:.3f}, comp {rows[0][1]:.3f}, overall "
          f"{rows[0][2]:.3f} [{card}]", flush=True)
    return {"render_s": render_s, "metric_s": metric_s, "dtu_s": dtu_s}



# --------------------------------------------------------------------------
# 11. BlendedMVS: the NeRF++ background model
# --------------------------------------------------------------------------

BMVS_SCAN = "scan1"        # in the inverse-depth list: stage 0 in 1/z
BMVS_EVAL_VIEW = 19        # scan1's first eval view
PROFILE_STEPS = 5          # the background step's profiled steps


def check_unclamped(dev, card: str) -> Dict:
    """Phase 11(a): the fused kernel at bounding_sphere = 0, both modes,
    on 65,536 points in a ball of radius 2r, against its plain version;
    the clamped call (bounding_sphere = r) differs outside the sphere."""
    cfg = bmvs_config()
    models = {"float32": cfg.model, "bfloat16": training_model_config(cfg)}
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                dev)
    r = cfg.model.scene_bounding_sphere
    rng = np.random.default_rng(11)
    d = rng.normal(size=(KERNEL_SWEEP, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    pts = torch.as_tensor((d * 2 * r * rng.uniform(0, 1, (KERNEL_SWEEP, 1))
                           ** (1 / 3)).astype(np.float32), device=dev)
    outside = torch.linalg.norm(pts, dim=-1) > r
    out = {}
    for mode, mcfg in models.items():
        got = fused_sdf.fused_sdf_values(params.sdf, mcfg, pts, 0.0)
        ref = fused_sdf.sdf_values_plain(params.sdf, mcfg, pts, 0.0)
        if mode == "float32":
            err = (got - ref).abs().max().item()
            _check(err <= KERNEL_TOL, f"unclamped kernel vs plain: {err}")
        else:
            err = _bf16_within(got, ref)
        clamped = fused_sdf.fused_sdf_values(params.sdf, mcfg, pts, r)
        moved = (clamped != got)[outside].float().mean().item()
        _check(moved > 0.99,
               f"{mode}: the clamp moves {moved} of the points outside")
        pack = fused_sdf.pack_sdf(params.sdf, mcfg)
        ms = _median_ms(lambda: fused_sdf.fused_sdf_values(
            params.sdf, mcfg, pts, 0.0, pack=pack))
        print(f"[bmvs] fused_sdf {mode} mode unclamped (bounding_sphere 0) "
              f"vs plain on {KERNEL_SWEEP} pts in a ball of radius {2 * r}: "
              f"max|diff| {err:.3e} ("
              + (f"tol {KERNEL_TOL}" if mode == "float32" else
                 f"tol {BF16_KERNEL_UNITS} (|sdf| + 1)")
              + f"); the clamp at r = {r} moves {100 * moved:.1f}% of the "
              f"{int(outside.sum())} points outside; kernel {ms:.4f} ms "
              f"[{card}]", flush=True)
        out[mode] = {"err": err, "ms": ms}
        del got, ref, clamped, pack
    return out


def _profile_steps(trainer: VolTrainer, n: int) -> Dict:
    """torch.profiler over n more steps (tools/time_step.py's method):
    device ms a step, kernels and copies launched a step."""
    from torch.profiler import ProfilerActivity
    from s_volsdf_tpu_torch.tools.time_step import _device_time
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        trainer.run(n)
        torch.cuda.synchronize()
    busy, launches = _device_time(prof)
    return {"device_ms": 1e3 * busy / n, "launches": launches / n}


def run_bmvs_training(dev, card: str) -> Dict:
    """Phase 11(b): the background step at the bmvs preset's full widths,
    bench.py's shapes, 20 steps at the defaults and 20 in float32, then
    PROFILE_STEPS profiled. Returns the launches of the 40 steps."""
    _reset_counts()                             # this path starts
    runs = {}
    for what, cfg in (("defaults", bmvs_config()),
                      ("float32", float32_config(bmvs_config()))):
        trainer = make_trainer(cfg, (cfg.max_h, cfg.max_w), BENCH_VOLUMES, dev)
        before = dict(fused_sdf.fused_sdf_values.mode_launches)
        trainer.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        modes = {m: n - before[m]
                 for m, n in fused_sdf.fused_sdf_values.mode_launches.items()}
        losses = [lo.loss for lo in trainer.losses]
        _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses))
               and all(lo.grad_finite == 1.0 for lo in trainer.losses),
               f"bmvs {what}: finite losses and grads: {losses}")
        mode = "bfloat16" if what == "defaults" else "float32"
        _check(modes[mode] == TRAIN_STEPS and sum(modes.values()) == TRAIN_STEPS,
               f"bmvs {what}: fused launches {modes}")
        runs[what] = (trainer, losses, modes)
    launches = _launch_counts()                 # ... and ends here
    for what, (trainer, losses, modes) in runs.items():
        step_ms = 1e3 * float(np.median(trainer.chunk_seconds))
        prof = _profile_steps(trainer, PROFILE_STEPS)
        print(f"[bmvs] background step {what}: {TRAIN_STEPS} steps at "
              f"{trainer.cfg.train.num_pixels} rays: loss {losses[0]:.5f} -> "
              f"{losses[-1]:.5f}, median {step_ms:.2f} ms/step; profiled "
              f"{PROFILE_STEPS}: device {prof['device_ms']:.2f} ms/step, busy "
              f"{100 * prof['device_ms'] / step_ms:.1f}%, "
              f"{prof['launches']:.0f} launches/step; fused SDF launches "
              f"{sum(modes.values()) / TRAIN_STEPS:.0f}/step {modes} "
              f"[{card}]", flush=True)
    del runs
    return launches


def bmvs_scene_config(data_root: str) -> Config:
    """The bmvs preset at the JAX defaults on the BMVS fixture at 576x768,
    x2 MVS shapes, scan1's overrides (stage 0 in inverse depth)."""
    cfg = bmvs_config()
    cfg.data_dir_root = cfg.dataset.data_dir_root = data_root
    cfg.max_h, cfg.max_w = CASCADE_RES
    cfg.dataset.img_res = tuple(CASCADE_RES)
    cfg.mvs.ndepths, cfg.mvs.numdepth = CASCADE_NDEPTHS, CASCADE_NDEPTHS[0]
    cfg.mvs.x2_mvsres = CASCADE_X2
    cfg.mvs.interval_scale = 1.0
    cfg.opt_stepNs = (TRAIN_STEPS, 0, 0)
    cfg.filter.eval_mask = False
    return per_scene_overrides(cfg, BMVS_SCAN)


def run_bmvs_scene(dev, card: str, tmp: str) -> Dict:
    """Phase 11(c) and (d): save_scene_depth and pcd_filter on a 576x768
    BMVS fixture of JPEG images, then the background eval render of one
    eval view and cli.eval_bmvs on a sphere GT cloud. Returns the
    launches of (c)."""
    data_root = os.path.join(tmp, "bmvs")
    make_bmvs_fixture(data_root, img_res=CASCADE_RES, image_format="jpg")
    cfg = bmvs_scene_config(data_root)
    _check(cfg.inverse_depth, "scan1 runs stage 0 in inverse depth")
    engine = MVSEngine(cfg, device=dev)
    he_gain(engine.net)
    exps = os.path.join(tmp, "bmvs_exps")
    _reset_counts()                             # this path starts
    t0 = time.perf_counter()
    res = save_scene_depth(cfg, BMVS_SCAN, exps_root=exps, engine=engine)
    torch.cuda.synchronize()
    scene_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    (ply,) = pcd_filter(cfg, [BMVS_SCAN], exps_root=exps, device=dev)
    torch.cuda.synchronize()
    fuse_s = time.perf_counter() - t0
    launches = _launch_counts()                 # ... and ends here
    trainer = res["trainer"]
    losses = [lo.loss for lo in trainer.losses]
    _check(len(losses) == TRAIN_STEPS and all(np.isfinite(losses)),
           f"bmvs scene: finite losses {losses}")
    _check(launches["fused_sdf"]["bfloat16"] == TRAIN_STEPS
           and launches["fused_sdf"]["float32"] > 0
           and launches["cost_mapping"] == TRAIN_STEPS
           and launches["geo_consistency"] > 0,
           f"bmvs scene launches {launches}")
    H2, W2 = CASCADE_MVS_RES
    for vid in trainer.trains_i:
        for kind in ("depth_est", "confidence"):
            arr, _ = read_pfm(os.path.join(res["outdir"], BMVS_SCAN, kind,
                                           f"{vid:08d}.pfm"))
            _check(arr.shape == (H2, W2) and np.isfinite(arr).all(),
                   f"bmvs {kind} {vid}: {arr.shape}, finite "
                   f"{np.isfinite(arr).all()}")
    xyz, _ = load_ply(ply)
    _check(xyz.shape[0] > 0, "bmvs: an empty fused cloud")
    print(f"[bmvs] save_scene_depth {BMVS_SCAN} (inverse-depth stage 0), MVS "
          f"{H2}x{W2}, D {'/'.join(map(str, CASCADE_NDEPTHS))}, "
          f"{TRAIN_STEPS} background steps at the defaults: {scene_s:.2f} s; "
          f"stages " + ", ".join(
              f"{sec:.3f} s ({peak / 2**30:.2f} GiB)" for sec, peak in
              zip(res["stage_seconds"], res["stage_peak_bytes"]))
          + f"; median {1e3 * float(np.median(trainer.step_seconds)):.2f} "
          f"ms/step, loss {losses[0]:.5f} -> {losses[-1]:.5f}; feedback "
          f"renders " + ", ".join(f"{x:.3f} s" for x in res["feedback_seconds"])
          + f"; pcd_filter {fuse_s:.2f} s, {xyz.shape[0]} points; launches "
          f"{launches} [{card}]", flush=True)

    # (d) The eval render with the nearest training view's directions,
    # then the Chamfer command line against points on the fixture's sphere.
    near = trainer.scene.near_pose(BMVS_EVAL_VIEW)
    _check(near is not None and not np.array_equal(
        near, trainer.scene.poses[BMVS_EVAL_VIEW]), "scan1's near pose")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    maps = trainer.render_view(BMVS_EVAL_VIEW)
    torch.cuda.synchronize()
    render_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    _check(all(np.isfinite(m).all() for m in maps.values())
           and maps["rgb"].shape == CASCADE_RES + (3,),
           "bmvs eval render: finite maps")
    # scan1's relative scale (1.005e-3) makes the protocol's 20 mm bound
    # 0.02 units of the fixture's 200-unit frame, past the spacing of any
    # sphere cloud: its Chamfer is NaN (no neighbour within the bound),
    # and only shows that the command line runs. The fused cloud as its
    # own GT must score 0.
    gt_path = os.path.join(data_root, "BlendedMVS", "stl", f"{BMVS_SCAN}.ply")
    argv = ["--datadir", os.path.dirname(ply), "--data_dir_root", data_root,
            "--scan", BMVS_SCAN[4:], "--no_crop"]
    save_ply(gt_path, sphere_points(GT_POINTS // 10))
    t0 = time.perf_counter()
    (sphere_mm,) = cli_eval_bmvs.main(argv)
    eval_s = time.perf_counter() - t0
    save_ply(gt_path, xyz)
    (self_mm,) = cli_eval_bmvs.main(argv)
    _check(self_mm == 0.0, f"bmvs chamfer of the cloud against itself "
           f"{self_mm}")
    print(f"[bmvs] render_image of eval view {BMVS_EVAL_VIEW} at "
          f"{CASCADE_RES[0]}x{CASCADE_RES[1]} with its near pose: "
          f"{render_s:.2f} s, peak allocated {peak / 2**30:.2f} GiB, acc "
          f"{maps['acc'].mean():.4f}; cli.eval_bmvs {eval_s:.2f} s: against "
          f"the sphere {sphere_mm:.3f} (NaN: nothing within 20 mm at scan1's "
          f"scale), against itself {self_mm:.3f} [{card}]", flush=True)
    del res, trainer, engine, maps
    return launches


# --------------------------------------------------------------------------
# 12. The image path: JPEG scenes and image-based rendering
# --------------------------------------------------------------------------

JPEG_PSNR_MIN = 35.0   # phase 11's fixture decoded, against its source (dB)
IBR_PSNR_MIN = 20.0    # the blend against the GT eval view (tests/test_ibr.py)
IBR_TRAIN_IDS = (25, 22, 28)   # DTU's training views (scan106)
IBR_GEO_LAUNCHES = 3   # geometric checks a blended view: one a training view
# The warps at 576x768 with GT depths: the share of the eval view's sphere
# pixels that pass some training view's check (0.932 measured on the
# CPU) and the warped images' PSNR on their passing pixels (51.9-53.3
# dB; the render alone, a uint8 copy of the GT view, gives 52.6).
IBR_COVER_MIN, IBR_WARP_PSNR_MIN = 0.9, 40.0
IBR_BLEND_TOL = 1e-5   # the blend on the card against the CPU's
DECODE_REPS = 20


def _uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _psnr(a: np.ndarray, b: np.ndarray, peak: float) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return float(10 * np.log10(peak ** 2 / mse))


def check_jpeg_scene(card: str, tmp: str) -> Dict:
    """Phase 12(a): phase 11's scene is JPEGs only; one 576x768 training
    image's decode, timed on the host, against the fixture's source."""
    image_dir = os.path.join(tmp, "bmvs", "BlendedMVS", BMVS_SCAN, "image")
    names = sorted(os.listdir(image_dir))
    _check(len(names) > 0 and all(n.endswith(".jpg") for n in names),
           f"phase 11's images are JPEGs: {names[:3]}")
    tid = get_trains_ids("BlendedMVS", BMVS_SCAN, 3)[0]   # the scene's view 0
    path = os.path.join(image_dir, f"{tid:06d}.jpg")
    with open(path, "rb") as f:
        data = f.read()
    times = []
    for _ in range(DECODE_REPS):
        t0 = time.perf_counter()
        img = decode_jpeg(data, path)
        times.append(time.perf_counter() - t0)
    src = _uint8(make_sphere_scene(n_views=3, img_res=CASCADE_RES,
                                   cam_radius=2.8).images[0])
    _check(img.shape == src.shape, f"decoded {img.shape}, source {src.shape}")
    psnr = _psnr(img, src, 255.0)
    _check(psnr >= JPEG_PSNR_MIN, f"JPEG decode PSNR {psnr} dB")
    ms = 1e3 * float(np.median(times))
    print(f"[image] phase 11's {BMVS_SCAN} scene read {len(names)} JPEG "
          f"images (quality 95, 4:2:0); decode of {os.path.basename(path)} "
          f"({CASCADE_RES[0]}x{CASCADE_RES[1]}, {len(data)} bytes): "
          f"{ms:.3f} ms on the host (median of {DECODE_REPS}); PSNR against "
          f"the fixture's source {psnr:.2f} dB (at least {JPEG_PSNR_MIN}) "
          f"[{card}]", flush=True)
    return {"decode_ms": ms, "psnr": psnr}


def write_ibr_scene(root: str, img_res):
    """tests/test_ibr.py's scene at img_res: three training views and one
    eval view of the sphere (GT depths, the background at twice the
    farthest depth), the eval view under every DTU eval id, with its GT
    image as the render. Returns (scene, scan folder, out folder)."""
    scene = make_sphere_scene(n_views=4, img_res=img_res, cam_radius=2.5)
    scan_folder, out_folder = (os.path.join(root, d) for d in (SCAN, "out"))
    views = [(v, i) for i, v in enumerate(IBR_TRAIN_IDS)]
    views += [(v, 3) for v in get_eval_ids("DTU", int(SCAN[4:]))]
    for vid, i in views:
        cam = np.zeros((2, 4, 4), np.float32)
        cam[0] = np.linalg.inv(scene.poses[i])
        cam[1, :3, :3] = scene.intrinsics[i][:3, :3]
        write_cam(os.path.join(scan_folder, f"cams/{vid:08d}_cam.txt"), cam)
        depth = scene.depths[i].copy()
        depth[~np.isfinite(depth)] = depth[np.isfinite(depth)].max() * 2
        save_pfm(os.path.join(out_folder, f"depth_est/{vid:08d}.pfm"),
                 depth.astype(np.float32))
        write_png(os.path.join(out_folder, f"eval_{vid:03d}.png") if i == 3
                  else os.path.join(scan_folder, f"images/{vid:08d}.png"),
                  _uint8(scene.images[i]))
    return scene, scan_folder, out_folder


def run_ibr(dev, card: str, tmp: str) -> Dict:
    """Phase 12(b): image_based_render on the card at 576x768."""
    scene, scan_folder, out_folder = write_ibr_scene(
        os.path.join(tmp, "ibr"), CASCADE_RES)
    n_evals = len(get_eval_ids("DTU", int(SCAN[4:])))
    t0 = time.perf_counter()
    written = image_based_render(scan_folder, out_folder, "DTU", 3,
                                 device=dev)
    torch.cuda.synchronize()
    ibr_s = time.perf_counter() - t0
    _check(len(written) == n_evals and all(map(os.path.isfile, written)),
           f"IBR wrote {len(written)} of {n_evals} blends")
    blend = read_img(written[0])
    _check(blend.shape == CASCADE_RES + (3,), f"blend {blend.shape}")
    psnr = _psnr(blend, scene.images[3], 1.0)
    _check(psnr > IBR_PSNR_MIN, f"IBR blend PSNR {psnr} dB")
    print(f"[image] image_based_render at {CASCADE_RES[0]}x{CASCADE_RES[1]} "
          f"(GT depths, 3 training views, {n_evals} eval views): {ibr_s:.2f} "
          f"s, {ibr_s / n_evals:.4f} s/view (PNG reads and writes included); "
          f"blend PSNR against the GT eval view {psnr:.2f} dB (above "
          f"{IBR_PSNR_MIN}) [{card}]", flush=True)
    return {"s_per_view": ibr_s / n_evals, "psnr": psnr, "views": n_evals,
            "scene": scene, "scan_folder": scan_folder,
            "out_folder": out_folder}


def check_ibr_view(dev, card: str, run: Dict) -> None:
    """Phase 12(b), outside the counted run: on run_ibr's first eval
    view, the geometric check's kernel against its plain version at
    IBR's inputs, the warps' coverage and PSNR, and the blend on the
    card against the CPU's."""
    scan_folder, out_folder = run["scan_folder"], run["out_folder"]
    vid = get_eval_ids("DTU", int(SCAN[4:]))[0]
    on = {d: ([ibr_mod.view_inputs(scan_folder, out_folder, v, d, image=True)
               for v in IBR_TRAIN_IDS],
              ibr_mod.view_inputs(scan_folder, out_folder, vid, d,
                                  image=False)) for d in (dev, "cpu")}
    srcs, ref = on[dev]
    gt = torch.as_tensor(read_img(os.path.join(out_folder,
                                               f"eval_{vid:03d}.png")))
    sphere = torch.isfinite(torch.as_tensor(run["scene"].depths[3]))
    covered = torch.zeros_like(sphere)
    mask_diff, depth_err, xy_err, warp_psnr = 0, 0.0, 0.0, []
    for src in srcs:
        mats = geo_consistency.pair_matrices(ref["intr"], ref["extr"],
                                             src["intr"], src["extr"])
        args = (ref["depth"], src["depth"], mats, ibr_mod.FILTER_DIST,
                ibr_mod.FILTER_DIFF)
        got = geo_consistency.geo_consistency(*args, xy=True)
        want = geo_consistency.geo_consistency_plain(*args, xy=True)
        mask_diff += int((got[0] != want[0]).sum())
        depth_err = max(depth_err, (got[1] - want[1]).abs().max().item())
        xy_err = max(xy_err, (got[2] - want[2]).abs().max().item(),
                     (got[3] - want[3]).abs().max().item())
        mask = got[0].cpu()
        covered |= mask
        warped = remap_cubic(src["image"], got[2].float(), got[3].float())
        warp_psnr.append(_psnr(warped.cpu()[mask], gt[mask], 1.0))
    _check(mask_diff == 0 and depth_err <= FUSION_DEPTH_TOL
           and xy_err <= FUSION_XY_TOL,
           f"IBR geo_consistency vs plain: {mask_diff} mask pixels differ, "
           f"depth {depth_err}, x/y {xy_err}")
    cover = int((covered & sphere).sum()) / int(sphere.sum())
    _check(cover >= IBR_COVER_MIN and min(warp_psnr) >= IBR_WARP_PSNR_MIN,
           f"IBR warps: {cover} of the sphere covered, PSNR {warp_psnr}")
    blends = [ibr_mod.blend_view(r, gt.to(r["depth"].device), s).cpu()
              for s, r in on.values()]
    blend_err = (blends[0] - blends[1]).abs().max().item()
    _check(blend_err <= IBR_BLEND_TOL, f"IBR blend card vs CPU {blend_err}")
    print(f"[image] IBR eval view {vid}, {len(srcs)} training views at "
          f"{CASCADE_RES[0]}x{CASCADE_RES[1]}: geo_consistency (filter_dist "
          f"{ibr_mod.FILTER_DIST}, x/y) vs plain: mask pixels differing "
          f"{mask_diff}, depth max|diff| {depth_err:.3e}, x/y max|diff| "
          f"{xy_err:.3e} (tol {FUSION_XY_TOL}); sphere pixels passing some "
          f"training view {cover:.4f} (at least {IBR_COVER_MIN}); warped "
          f"PSNR on passing pixels " + ", ".join(f"{p:.2f}" for p in warp_psnr)
          + f" dB (at least {IBR_WARP_PSNR_MIN}); blend card vs CPU "
          f"max|diff| {blend_err:.3e} (tol {IBR_BLEND_TOL}) [{card}]",
          flush=True)


def ibr_command_lines(dev, card: str, tmp: str) -> Dict:
    """Phase 12(c): create_scene=true on phase 7(d)'s fixture, cli.ibr on
    phase 8(e)'s rendering_<epoch> folder, the blends' metrics."""
    outdir = os.path.join(tmp, "small_ibr")
    t0 = time.perf_counter()
    _check(cli_run.main(small_run_args(tmp, outdir) + ["create_scene=true"])
           == [], "create_scene=true fuses nothing")
    create_s = time.perf_counter() - t0
    scan_dir = os.path.join(outdir, SCAN)
    n_evals = len(get_eval_ids("DTU", int(SCAN[4:])))
    n_cams, n_images = (len(os.listdir(os.path.join(scan_dir, d)))
                        for d in ("cams", "images"))
    _check(n_images == 3 and n_cams == 3 + n_evals,
           f"create_scene wrote {n_cams} cams and {n_images} images")
    t0 = time.perf_counter()
    blends = cli_ibr.main([f"evals_folder={os.path.join(tmp, SMALL_EVALS)}",
                           f"outdir={outdir}", f"testlist={SCAN}"])
    torch.cuda.synchronize()
    ibr_s = time.perf_counter() - t0
    _check(len(blends) == n_evals and all(map(os.path.isfile, blends)),
           f"cli.ibr wrote {len(blends)} of {n_evals} blends")
    t0 = time.perf_counter()
    (m,) = cli_eval_vsdf.main(["--eval_rendering", "--result_from", "blend"]
                              + small_eval_args(tmp))
    metric_s = time.perf_counter() - t0
    _check(m["n_views"] == n_evals and np.isfinite(m["psnr_mean"])
           and 0 < m["ssim_mean"] <= 1, f"blend metrics {m}")
    print(f"[image] cli.run create_scene=true {SCAN} at {SMALL_RES[0]}x"
          f"{SMALL_RES[1]}: {create_s:.2f} s ({n_cams} cams, {n_images} "
          f"images); cli.ibr on {os.path.basename(os.path.dirname(blends[0]))}"
          f": {ibr_s:.2f} s, {len(blends)} blends; cli.eval_vsdf "
          f"--result_from blend {metric_s:.2f} s: PSNR {m['psnr_mean']:.3f}, "
          f"SSIM {m['ssim_mean']:.4f} over {m['n_views']} views [{card}]",
          flush=True)
    return {"views": len(blends)}


# Phase 13: multi-scene training in lockstep.
MS_SCENES = 4               # scenes of 13(a) and the largest S of 13(b)
MS_SIZES = (1, 2, 4)        # S of the lockstep step
MS_RADII = (0.8, 0.7, 0.6, 0.5)   # each scene's sphere
MS_PROFILE_STEPS = 5
# S = 2 against two serial trainers, at float32: after one step each
# scene's loss within 1e-4 relative (cuBLAS's batched and single
# products may sum in other orders, so not to the bit); after 20 steps
# within 1% (test_five_steps_track_jax's bar).
MS_STEP1_RTOL = 1e-4
MS_TRACK_RTOL = 1e-2
MS_SCANS = ("scan106", "scan114")
MS_CLI_STEPS = 30
MS_DEPTH_TOL, MS_DEPTH_SHARE = 1e-3, 0.995   # tests/test_multiscene_pipeline.py


def ms_scenes(device, n: int = MS_SCENES):
    """n 3-view 576x768 sphere scenes, scene s of radius MS_RADII[s],
    each with bench.py's float32 volumes (`make_volumes`)."""
    out = []
    for s in range(n):
        scene = make_sphere_scene(3, CASCADE_RES, sphere_radius=MS_RADII[s])
        out.append((scene, make_volumes(scene, BENCH_VOLUMES, device)))
    return out


def ms_trainers(cfg: Config, scenes, device):
    """A VolTrainer a scene, scene s's weights and generator from seed
    s, its volumes those of `scenes` (one step a chunk)."""
    trainers = []
    for s, (scene, mvs) in enumerate(scenes):
        c = copy.deepcopy(cfg)
        c.seed = s
        t = VolTrainer(c, scene_from_synthetic(scene), None, device=device,
                       chunk_steps=1)
        t.mvs = mvs
        trainers.append(t)
    return trainers


def check_scene_axis(dev, card: str, scenes) -> Dict:
    """Phase 13(a): the fused SDF kernel and the cost-mapping kernel each
    take MS_SCENES scenes in one launch, equal to that many single
    launches bit for bit, timed against them."""
    S = len(scenes)
    cfg = dtu_config()
    params = [init_volsdf_params(torch.Generator().manual_seed(s), cfg.model,
                                 dev) for s in range(S)]
    stacked = stack_params(params)
    pts = torch.as_tensor(np.random.default_rng(5).normal(
        size=(S, KERNEL_SWEEP, 3)).astype(np.float32), device=dev)
    flop = sdf_flops_per_point(params[0].sdf)
    out = {}
    for mode, mcfg in (("float32", cfg.model),
                       ("bfloat16", training_model_config(cfg))):
        pack = fused_sdf.pack_sdf_scenes(stacked.sdf, mcfg)
        packs = [fused_sdf.pack_sdf(p.sdf, mcfg) for p in params]
        got = fused_sdf.fused_sdf_values(stacked.sdf, mcfg, pts, 3.0,
                                         pack=pack)
        singles = [fused_sdf.fused_sdf_values(p.sdf, mcfg, pts[s], 3.0,
                                              pack=k)
                   for s, (p, k) in enumerate(zip(params, packs))]
        ref = fused_sdf.sdf_values_plain(stacked.sdf, mcfg, pts, 3.0)
        torch.cuda.synchronize()
        _check(all(torch.equal(got[s], singles[s]) for s in range(S)),
               f"fused_sdf {mode}: the {S}-scene launch differs from {S} "
               f"single launches")
        if mode == "float32":
            err = (got - ref).abs().max().item()
            _check(err <= KERNEL_TOL, f"fused_sdf {S} scenes vs plain: {err}")
        else:
            err = _bf16_within(got, ref)
        batched_ms = _median_ms(lambda: fused_sdf.fused_sdf_values(
            stacked.sdf, mcfg, pts, 3.0, pack=pack))
        singles_ms = _median_ms(lambda: [fused_sdf.fused_sdf_values(
            p.sdf, mcfg, pts[s], 3.0, pack=k)
            for s, (p, k) in enumerate(zip(params, packs))])
        products = 3 if mode == "float32" else 1
        bound_ms = products * S * KERNEL_SWEEP * flop / (BF16_TFLOPS * 1e12) * 1e3
        print(f"[multiscene] fused_sdf {mode} mode, {S} scenes x "
              f"{KERNEL_SWEEP} pts: one launch equals {S} single launches "
              f"bit for bit; vs plain max|diff| {err:.3e}; one launch "
              f"{batched_ms:.4f} ms, {S} single launches {singles_ms:.4f} "
              f"ms (medians of 20), bound {bound_ms:.4f} ms: "
              f"{100 * bound_ms / batched_ms:.1f}% of bound [{card}]",
              flush=True)
        out[f"fused_sdf_{mode}"] = {"err": err, "ms": batched_ms,
                                    "singles_ms": singles_ms,
                                    "bound_ms": bound_ms}
        del pack, packs, got, singles, ref
    del params, stacked, pts

    xyz = torch.stack([cost_mapping_samples(sc, s % 3, dev)
                       for s, (sc, _) in enumerate(scenes)])
    onehot = torch.eye(3, device=dev)[[s % 3 for s in range(S)]]
    for dtype in (torch.bfloat16, torch.float32):
        vols = [dataclasses.replace(m, prob=m.prob.to(dtype))
                for _, m in scenes]
        t0 = time.perf_counter()
        stacked_vols = cost_mapping.check_volumes_scenes(vols)
        torch.cuda.synchronize()
        pack_ms = 1e3 * (time.perf_counter() - t0)
        single_vols = [cost_mapping.check_volumes(m) for m in vols]
        got = cost_mapping.cost_mapping(None, xyz, onehot, stacked_vols)
        singles = [cost_mapping.cost_mapping(None, xyz[s], onehot[s], m)
                   for s, m in enumerate(single_vols)]
        torch.cuda.synchronize()
        for s in range(S):
            for a, b in zip(got, singles[s]):
                _check(torch.equal(a[s], b), f"cost_mapping {dtype}: scene "
                       f"{s} of the {S}-scene launch differs from its "
                       f"single launch")

        def batched():
            cost_mapping.cost_mapping(None, xyz, onehot, stacked_vols)

        def single_launches():
            for s, m in enumerate(single_vols):
                cost_mapping.cost_mapping(None, xyz[s], onehot[s], m)
        warm = _median_ms(batched, backlog=True)
        warm_singles = _median_ms(single_launches, backlog=True)
        cold = float(np.median(cold_ms([batched] * 20)))
        cold_singles = float(np.median(cold_ms([single_launches] * 20)))
        nbytes = sum(min(cost_mapping.packed_bytes(xyz[s], m),
                         cost_mapping.touched_bytes(xyz[s], m))
                     for s, m in enumerate(single_vols))
        bound_ms = nbytes / (HBM_TBPS * 1e12) * 1e3
        name = str(dtype).replace("torch.", "")
        print(f"[multiscene] cost_mapping {name} volumes, {S} scenes x "
              f"{COST_RAYS}x{COST_SAMPLES} samples x 3 views of "
              f"{BENCH_VOLUMES}: one launch equals {S} single launches bit "
              f"for bit (pj, pi, valid); one launch cold {cold:.4f} ms, "
              f"warm {warm:.4f} ms; {S} single launches cold "
              f"{cold_singles:.4f} ms, warm {warm_singles:.4f} ms (device, "
              f"medians of 20); bound {bound_ms:.4f} ms ({nbytes} bytes at "
              f"{HBM_TBPS} TB/s); the stacked corner-block copy made in "
              f"{pack_ms:.1f} ms (host clock) [{card}]", flush=True)
        out[f"cost_mapping_{name}"] = {
            "ms_cold": cold, "ms_warm": warm, "singles_ms_cold": cold_singles,
            "singles_ms_warm": warm_singles, "bound_ms": bound_ms,
            "pack_ms": pack_ms}
        del stacked_vols, single_vols, vols, got, singles
        torch.cuda.empty_cache()
    return out


def _profile_joint(trainers, n: int) -> Dict:
    """torch.profiler over n more lockstep steps: device ms a step,
    kernels and copies launched a step."""
    from torch.profiler import ProfilerActivity
    from s_volsdf_tpu_torch.tools.time_step import _device_time
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        run_joint(trainers, n)
        torch.cuda.synchronize()
    busy, launches = _device_time(prof)
    return {"device_ms": 1e3 * busy / n, "launches": launches / n}


def check_nan_scene(dev, trainers) -> None:
    """Phase 13(b), last: one lockstep step of two scenes with NaN in
    scene 1's RGB: scene 1's grad_finite is 0 and its parameters and
    Adam state stay equal to the bit; scene 0 steps."""
    from s_volsdf_tpu_torch.engine.train_step import make_multiscene_one_step
    from s_volsdf_tpu_torch.engine.multiscene import _pack_stacked
    cfg = trainers[0].cfg
    state = stack_states([t.state for t in trainers])
    step = make_multiscene_one_step(cfg, state.opt_state, use_mvs=True,
                                    n_views=3, img_res=trainers[0].scene.img_res)
    scenes = [t.scene_tensors() for t in trainers]
    scenes[1]["rgb"] = scenes[1]["rgb"] * float("nan")
    scenes[1]["rgb_smooth"] = scenes[1]["rgb_smooth"] * float("nan")
    before = [{n: p[s].detach().clone() for n, p in
               state.params.named_parameters()} for s in range(2)]
    moments = [m.detach().clone() for m in
               state.opt_state.exp_avg + state.opt_state.exp_avg_sq]
    counts = [state.opt_state.count(s) for s in range(2)]
    state, lo = step(scenes, _pack_stacked(cfg, trainers), state,
                     [t.gen for t in trainers])
    torch.cuda.synchronize()
    _check(lo.grad_finite == (1.0, 0.0), f"NaN scene: grad_finite "
           f"{lo.grad_finite}, want (1.0, 0.0)")
    same1 = all(torch.equal(p[1], before[1][n])
                for n, p in state.params.named_parameters())
    same1 = same1 and all(torch.equal(m[1], b[1]) for m, b in zip(
        state.opt_state.exp_avg + state.opt_state.exp_avg_sq, moments))
    moved0 = any(not torch.equal(p[0], before[0][n])
                 for n, p in state.params.named_parameters())
    _check(same1 and moved0 and state.opt_state.count(1) == counts[1]
           and state.opt_state.count(0) == counts[0] + 1,
           f"NaN scene: scene 1 unchanged {same1}, scene 0 moved {moved0}, "
           f"counts {counts} -> {[state.opt_state.count(s) for s in (0, 1)]}")


def run_lockstep(dev, card: str, scenes) -> Dict:
    """Phase 13(b): the lockstep step at full width, S in MS_SIZES, at
    the defaults and at float32, against serial trainers of the same
    seeds. Returns the numbers per precision and S."""
    out = {}
    for precision, base in (("defaults", dtu_config),
                            ("float32", float32_dtu_config)):
        cfg = base()
        serial = ms_trainers(cfg, scenes, dev)
        for t in serial:
            t.run(TRAIN_STEPS)
        torch.cuda.synchronize()
        serial_ms = [1e3 * float(np.median(t.chunk_seconds)) for t in serial]
        serial_losses = np.array([[lo.loss for lo in t.losses]
                                  for t in serial])
        prof = _profile_steps(serial[0], MS_PROFILE_STEPS)
        print(f"[multiscene] serial {precision}: medians "
              + ", ".join(f"{m:.2f}" for m in serial_ms) + " ms/step; scene "
              f"0 device {prof['device_ms']:.2f} ms/step, busy "
              f"{100 * prof['device_ms'] / serial_ms[0]:.1f}%, "
              f"{prof['launches']:.0f} launches/step [{card}]", flush=True)
        for S in MS_SIZES:
            trainers = ms_trainers(cfg, scenes[:S], dev)
            torch.cuda.reset_peak_memory_stats(dev)
            before = _launch_counts()
            run_joint(trainers, TRAIN_STEPS, chunk_steps=TRAIN_STEPS)
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            after = _launch_counts()
            sdf_n = sum(after["fused_sdf"].values()) - sum(
                before["fused_sdf"].values())
            cost_n = after["cost_mapping"] - before["cost_mapping"]
            scene_sdf = (after["fused_sdf_scenes"].get(S, 0)
                         - before["fused_sdf_scenes"].get(S, 0))
            _check(sdf_n == TRAIN_STEPS and cost_n == TRAIN_STEPS
                   and scene_sdf == TRAIN_STEPS,
                   f"{precision} S={S}: {TRAIN_STEPS} steps launched the "
                   f"fused SDF kernel {sdf_n} times ({scene_sdf} of {S} "
                   f"scenes) and the cost mapping {cost_n} times")
            losses = np.array([[lo.loss for lo in t.losses]
                               for t in trainers])
            _check(losses.shape == (S, TRAIN_STEPS)
                   and np.isfinite(losses).all()
                   and all(t.last_guard_trips == 0 for t in trainers),
                   f"{precision} S={S}: finite losses {losses}")
            step_ms = 1e3 * float(np.median(trainers[0].step_seconds))
            if precision == "float32" and S <= 2:
                ref = serial_losses[:S]
                rel = np.abs(losses - ref) / np.abs(ref)
                _check(rel[:, 0].max() <= MS_STEP1_RTOL
                       and rel.max() <= MS_TRACK_RTOL,
                       f"S={S} vs serial: step-1 {rel[:, 0].max()} (bar "
                       f"{MS_STEP1_RTOL}), all steps {rel.max()} (bar "
                       f"{MS_TRACK_RTOL})")
                track = (f"; vs serial: step 1 {rel[:, 0].max():.2e}, "
                         f"all {TRAIN_STEPS} steps {rel.max():.2e} relative")
            else:
                track = ""
            prof = _profile_joint(trainers, MS_PROFILE_STEPS)
            row = {"median_ms": step_ms, "device_ms": prof["device_ms"],
                   "busy": prof["device_ms"] / step_ms,
                   "launches": prof["launches"], "peak_gib": peak,
                   "rays_s": S * trainers[0].cfg.train.num_pixels
                   / (step_ms / 1e3),
                   "serial_total_ms": sum(serial_ms[:S])}
            out[(precision, S)] = row
            print(f"[multiscene] lockstep {precision} S={S}: loss "
                  + ", ".join(f"{a:.5f} -> {b:.5f}" for a, b in
                              zip(losses[:, 0], losses[:, -1]))
                  + f"; median {step_ms:.2f} ms/step, device "
                  f"{row['device_ms']:.2f} ms/step, busy "
                  f"{100 * row['busy']:.1f}%, {row['launches']:.0f} "
                  f"launches/step, peak {peak:.2f} GiB, "
                  f"{row['rays_s']:.1f} training rays/s; {S} serial steps "
                  f"{row['serial_total_ms']:.2f} ms ("
                  + " + ".join(f"{m:.2f}" for m in serial_ms[:S])
                  + f"){track} [{card}]", flush=True)
            if precision == "float32" and S == 2:
                check_nan_scene(dev, trainers)
                print("[multiscene] NaN in scene 1's RGB for one step: its "
                      "grad_finite 0, its parameters and Adam state equal "
                      "to the bit; scene 0 stepped", flush=True)
            del trainers
            torch.cuda.empty_cache()
        del serial
        torch.cuda.empty_cache()
    return out


def ms_cli_args(root: str, run: str):
    """cli.run's arguments for the two 64x96 fixtures under root, 30
    float32 steps at stage 0, the run's own folders."""
    return [f"testlist={','.join(MS_SCANS)}",
            f"outdir={os.path.join(root, run, 'out')}",
            f"exps_folder={os.path.join(root, run, 'exps')}",
            f"data_dir_root={root}", f"dataset.data_dir_root={root}",
            f"max_h={SMALL_RES[0]}", f"max_w={SMALL_RES[1]}",
            f"dataset.img_res=[{SMALL_RES[0]},{SMALL_RES[1]}]",
            f"mvs.ndepths={list(SMALL_NDEPTHS)}",
            f"mvs.numdepth={SMALL_NDEPTHS[0]}", "mvs.x2_mvsres=false",
            f"opt_stepNs=[{MS_CLI_STEPS},0,0]",
            "train.train_compute_dtype=float32",
            "train.train_activation_dtype=float32",
            "train.mvs_pack_dtype=float32", "mvs.compute_dtype=float32"]


def ms_command_line(dev, card: str, tmp: str) -> Dict:
    """Phase 13(c): cli.run multiscene=true on two 64x96 DTU fixtures,
    then a serial cli.run of the same scans; every view's depth PFM
    within MS_DEPTH_TOL on at least MS_DEPTH_SHARE of its pixels; each
    scene's "latest" checkpoint resumes with is_continue."""
    root = os.path.join(tmp, "ms_small")
    for scan in MS_SCANS:
        make_dtu_fixture(root, scan_id=int(scan[4:]), img_res=SMALL_RES)
    seconds = {}
    for run, extra in (("joint", ["multiscene=true"]), ("serial", [])):
        t0 = time.perf_counter()
        plys = cli_run.main(ms_cli_args(root, run) + extra)
        torch.cuda.synchronize()
        seconds[run] = time.perf_counter() - t0
        _check(len(plys) == 2 and all(os.path.isfile(p) for p in plys),
               f"{run}: fused clouds {plys}")
    worst = 1.0
    cfg = validate_cli_config(root)
    for scan in MS_SCANS:
        for v in get_trains_ids(cfg.dataset.data_dir, scan, cfg.num_view):
            d = [read_pfm(os.path.join(root, run, "out", scan,
                                       f"depth_est/{v:08d}.pfm"))[0]
                 for run in ("joint", "serial")]
            share = float(np.isclose(d[0], d[1], rtol=MS_DEPTH_TOL,
                                     atol=MS_DEPTH_TOL).mean())
            _check(np.isfinite(d[0]).all() and share >= MS_DEPTH_SHARE,
                   f"{scan} view {v}: {share} of the depth pixels within "
                   f"{MS_DEPTH_TOL} of the serial run's")
            worst = min(worst, share)
        scene = load_scene(cfg.dataset.data_dir, tuple(cfg.dataset.img_res),
                           int(scan[4:]), cfg.num_view, cfg.data_dir_root)
        c = copy.deepcopy(cfg)
        c.exps_folder = os.path.join(root, "joint", "exps")
        resumed = VolTrainer(c, scene, scan, device=dev, exps_root=".",
                             is_continue=True)
        _check(resumed.state.iter_step == MS_CLI_STEPS,
               f"{scan}: the joint run's checkpoint resumed at step "
               f"{resumed.state.iter_step}")
    print(f"[multiscene] cli.run multiscene=true {','.join(MS_SCANS)} at "
          f"{SMALL_RES[0]}x{SMALL_RES[1]}, {MS_CLI_STEPS} float32 steps: "
          f"{seconds['joint']:.2f} s, serial {seconds['serial']:.2f} s; the "
          f"worst view's depth pixels within {MS_DEPTH_TOL} of the serial "
          f"run's: {100 * worst:.2f}% (bar {100 * MS_DEPTH_SHARE}%); both "
          f"scenes' latest checkpoints resume at step {MS_CLI_STEPS} "
          f"[{card}]", flush=True)
    return {"seconds": seconds, "worst_share": worst}


# --------------------------------------------------------------------------
# 14. Multi-device on the one card
# --------------------------------------------------------------------------

SHARD_STEPS = 20             # 14(a): the ray-sharded loop at one NCCL rank
SHARD_PROFILE_STEPS = 5
ALLREDUCE_REPS = 50
PAIR_STEPS = 5               # 14(b): two gloo ranks sharing the card
# tests/test_torch_train_step.py's one-step bars: float32 (each gradient
# element), and at the bf16 defaults each leaf and the whole gradient in
# L2 (a bf16 product's weight gradient is rounded to bf16, so the mean of
# the ranks' rounded halves moves by about a bf16 unit).
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL = 1e-4, 1e-3, 1e-5
BF16_LOSS_RTOL, BF16_LEAF_L2, BF16_WHOLE_L2 = 1e-2, 1e-1, 2e-2
CLI_RANKS, CLI_STEPS, CLI_PIXELS = 3, 30, 510   # 14(c)
STAGE_TOL = 1e-5             # 14(c): stage 0 one view a rank vs one process
RANK_TIMEOUT = 400.0         # seconds a group of spawned ranks may take


def step_agreement(cfg: Config, grads, lo, want, wlo) -> Dict:
    """A sharded step's loss and gradients against one process's on the
    same rays: the loss's relative gap, the largest leaf's and the whole
    gradient's relative L2 gaps, and whether they are within the one-step
    bars of `cfg`'s precision ("ok")."""
    w = float(wlo.loss.detach())
    loss_rel = abs(float(lo.loss) - w) / abs(w)
    leaf = max(float(torch.linalg.norm(g - x) / torch.linalg.norm(x))
               for g, x in zip(grads, want))
    whole = float(torch.sqrt(sum(torch.sum((g - x) ** 2)
                                 for g, x in zip(grads, want))
                             / sum(torch.sum(x ** 2) for x in want)))
    if cfg.train.train_compute_dtype == "float32":
        ok = loss_rel <= STEP_LOSS_RTOL and all(
            torch.allclose(g, x, rtol=STEP_GRAD_RTOL, atol=STEP_GRAD_ATOL)
            for g, x in zip(grads, want))
    else:
        ok = (loss_rel <= BF16_LOSS_RTOL and leaf <= BF16_LEAF_L2
              and whole <= BF16_WHOLE_L2)
    return {"loss_rel": loss_rel, "leaf_l2": leaf, "whole_l2": whole,
            "ok": bool(ok)}


def _params_bytes(params) -> bytes:
    return b"".join(p.detach().cpu().numpy().tobytes()
                    for p in params.parameters())


def _profile_run(run, state, n: int, scene, mvs, gen) -> Dict:
    """torch.profiler over n steps of a loop: device ms and launches a
    step (tools/time_step.py's method)."""
    from torch.profiler import ProfilerActivity
    from s_volsdf_tpu_torch.tools.time_step import _device_time
    with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                            ProfilerActivity.CUDA]) as prof:
        state, _, seconds = run(state, n, scene, mvs, gen)
        torch.cuda.synchronize()
    busy, launches = _device_time(prof)
    return {"device_ms": 1e3 * busy / n, "launches": launches / n,
            "busy": busy / sum(seconds)}


def _allreduce_us(group, params) -> Dict:
    """The flat gradient all-reduce (`Group.mean_flat`) on gradients of
    the parameters' shapes: device us a call (CUDA events over
    ALLREDUCE_REPS calls) and the bytes it reduces."""
    grads = [torch.randn_like(p) for p in params.parameters()]
    for _ in range(3):
        group.mean_flat(grads)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(ALLREDUCE_REPS):
        group.mean_flat(grads)
    end.record()
    torch.cuda.synchronize()
    return {"us": 1e3 * start.elapsed_time(end) / ALLREDUCE_REPS,
            "bytes": 4 * sum(g.numel() for g in grads)}


def one_nccl_rank(dev, card: str, tmp: str) -> Dict:
    """Phase 14(a): one NCCL rank at bench.py's shapes, at the defaults
    and at float32: make_sharded_train_step on an injected batch equal
    to train_step to the bit; 20 steps of the ray-sharded loop (finite
    losses) beside the single-process loop's 20 (median, device ms,
    busy share, launches a step); the flat gradient all-reduce's us and
    bytes."""
    pmesh.init_process_group(
        "cuda", init_method="file://" + os.path.join(tmp, "nccl_store"),
        env={"WORLD_SIZE": "1", "RANK": "0", "LOCAL_RANK": "0",
             "LOCAL_WORLD_SIZE": "1"})
    try:
        group = pmesh.node_group()
        out = {}
        for what, cfg in (("defaults", dtu_config()),
                          ("float32", float32_dtu_config())):
            res = (cfg.max_h, cfg.max_w)
            plain = make_trainer(cfg, res, BENCH_VOLUMES, dev)
            shard = VolTrainer(cfg, plain.scene, None, device=dev,
                               chunk_steps=1)
            shard.mvs = plain.mvs
            mvs = pack_for_chunk(cfg, plain.mvs)
            scene = plain.scene_tensors()
            batch = draw_step_inputs(
                scene, torch.Generator(device=dev).manual_seed(5), cfg=cfg,
                n_views=3, img_res=res, n_rays=cfg.train.num_pixels)
            _, lo_plain = train_step(plain.state, batch, None, mvs, cfg=cfg,
                                     tx=plain.tx, use_mvs=True)
            step = make_sharded_train_step(cfg, shard.tx, group, use_mvs=True)
            _, lo_shard = step(shard.state, shard_batch(batch, group), None,
                               mvs)
            torch.cuda.synchronize()
            _check(_params_bytes(plain.state.params)
                   == _params_bytes(shard.state.params)
                   and float(lo_plain.loss) == float(lo_shard.loss),
                   f"{what}: the sharded step at one NCCL rank differs from "
                   f"train_step")
            run = make_sharded_scan_train_fn(cfg, shard.tx, group,
                                             use_mvs=True, n_views=3,
                                             img_res=res)
            shard.state, losses, seconds = run(shard.state, SHARD_STEPS,
                                               scene, mvs, shard.gen)
            losses = [float(x.loss) for x in losses]
            _check(all(np.isfinite(losses)), f"{what}: sharded losses "
                   f"{losses}")
            plain.run(SHARD_STEPS)
            same = [a.loss == b for a, b in zip(plain.losses, losses)]
            prof_shard = _profile_run(run, shard.state, SHARD_PROFILE_STEPS,
                                      scene, mvs, shard.gen)
            prof_plain = _profile_steps(plain, SHARD_PROFILE_STEPS)
            prof_plain["busy"] = (prof_plain["device_ms"] / 1e3
                                  * SHARD_PROFILE_STEPS
                                  / sum(plain.chunk_seconds))
            ar = _allreduce_us(group, shard.state.params)
            out[what] = {"median_ms": 1e3 * float(np.median(seconds)),
                         "plain_median_ms":
                             1e3 * float(np.median(plain.step_seconds[
                                 :SHARD_STEPS])),
                         "shard": prof_shard, "plain": prof_plain,
                         "allreduce": ar}
            print(f"[multi] 14(a) one NCCL rank, {what}: the sharded step "
                  f"equals train_step to the bit (loss {losses[0]:.6f}); "
                  f"{SHARD_STEPS} ray-sharded steps: loss {losses[0]:.5f} -> "
                  f"{losses[-1]:.5f}, {sum(same)}/{SHARD_STEPS} losses equal "
                  f"to the single-process loop's, median "
                  f"{out[what]['median_ms']:.2f} ms/step (single process "
                  f"{out[what]['plain_median_ms']:.2f}), device "
                  f"{prof_shard['device_ms']:.2f} ms (single "
                  f"{prof_plain['device_ms']:.2f}), busy "
                  f"{prof_shard['busy']:.3f} (single {prof_plain['busy']:.3f}"
                  f"), launches {prof_shard['launches']:.0f}/step (single "
                  f"{prof_plain['launches']:.0f}); the flat gradient "
                  f"all-reduce {ar['us']:.1f} us for {ar['bytes']} bytes "
                  f"[{card}]", flush=True)
            del plain, shard, mvs
            torch.cuda.empty_cache()
        return out
    finally:
        pmesh.shutdown()


def sharded_step_agreement(cfg: Config, dev, group) -> tuple:
    """chip_smoke's trainer at bench.py's shapes and one sharded step's
    agreement with one process's on the same 512 rays and jitter
    (`step_agreement`, on the group's first rank; None elsewhere):
    (trainer, its packed volumes, its scene tensors, the agreement)."""
    res = (cfg.max_h, cfg.max_w)
    t = make_trainer(cfg, res, BENCH_VOLUMES, dev)
    mvs = pack_for_chunk(cfg, t.mvs)
    scene = t.scene_tensors()
    batch = draw_step_inputs(scene, torch.Generator(device=dev).manual_seed(5),
                             cfg=cfg, n_views=3, img_res=res,
                             n_rays=cfg.train.num_pixels)
    grads, lo = mean_over_group(group, *loss_and_grads(
        t.state.params, cfg, shard_batch(batch, group), None, mvs, 0))
    agree = None
    if group.first:
        agree = step_agreement(cfg, grads, lo, *loss_and_grads(
            t.state.params, cfg, batch, None, mvs, 0))
    return t, mvs, scene, agree


def pair_rank() -> Dict:
    """What each of 14(b)'s two gloo ranks on one card runs (spawned by
    `pair_ranks`)."""
    dev = pmesh.rank_device()
    group = pmesh.node_group()
    out = {"rank": group.index}
    out["agree_defaults"] = sharded_step_agreement(dtu_config(), dev,
                                                   group)[3]
    torch.cuda.empty_cache()
    cfg = float32_dtu_config()
    res = (cfg.max_h, cfg.max_w)
    t, mvs, scene, out["agree"] = sharded_step_agreement(cfg, dev, group)
    _reset_counts()
    run = make_sharded_scan_train_fn(cfg, t.tx, group, use_mvs=True,
                                     n_views=3, img_res=res)
    t.state, losses, seconds = run(t.state, PAIR_STEPS, scene, mvs, t.gen)
    torch.cuda.synchronize()
    out["step_launches"] = _launch_counts()
    out["losses"] = [float(x.loss) for x in losses]
    out["median_ms"] = 1e3 * float(np.median(seconds))
    out["params_sha"] = hashlib.sha256(_params_bytes(t.state.params)).hexdigest()
    del mvs
    t.mvs = None
    torch.cuda.empty_cache()
    egroup = pmesh.eval_group(cfg.parallel, 16384)
    pose, intr = t.scene.poses[0], t.scene.intrinsics[0]
    t0 = time.perf_counter()
    maps = render_depth(t.state.params, cfg.model, pose, intr, res,
                        chunk=16384, fast=-1, device=dev, group=egroup)
    torch.cuda.synchronize()
    out["render_s"] = time.perf_counter() - t0
    out["render_group"] = None if egroup is None else egroup.ranks
    if group.first:
        t0 = time.perf_counter()
        single = render_depth(t.state.params, cfg.model, pose, intr, res,
                              chunk=16384, fast=-1, device=dev)
        torch.cuda.synchronize()
        out["single_render_s"] = time.perf_counter() - t0
        d, w = maps["depth"], single["depth"]
        out["render_equal"] = bool(np.array_equal(d, w)
                                   and np.array_equal(maps["acc"],
                                                      single["acc"]))
        out["render_share"] = float(np.isclose(d, w, rtol=MS_DEPTH_TOL,
                                               atol=MS_DEPTH_TOL).mean())
        out["render_max_diff"] = float(np.abs(d - w).max())
        out["render_finite"] = bool(np.isfinite(d).all())
    out["launches"] = _launch_counts()
    return out


def pair_ranks(card: str) -> Dict:
    """Phase 14(b): two gloo ranks sharing the card (spawned; NCCL
    refuses two ranks on one device). The sharded step at 256 rays a
    rank against the single-process step on the same 512 rays and
    jitter, within the one-step bars; the replicas' parameters bit-equal
    after 5 steps; one fused-SDF and one cost-mapping launch a step in
    each rank; a sharded 576x768 render_depth against the single-process
    render. Its times are two processes sharing one card, not
    scaling."""
    t0 = time.perf_counter()
    r0, r1 = pmesh.run_local_ranks(pair_rank, 2, device="cuda:0",
                                   backend="gloo", timeout=RANK_TIMEOUT)
    seconds = time.perf_counter() - t0
    a, d = r0["agree"], r0["agree_defaults"]
    _check(a["ok"] and d["ok"],
           f"14(b): the sharded step against the single-process step: "
           f"float32 {a}, defaults {d}")
    _check(r0["params_sha"] == r1["params_sha"],
           "14(b): the replicas' parameters differ")
    for r in (r0, r1):
        sl = r["step_launches"]
        _check(sum(sl["fused_sdf"].values()) == PAIR_STEPS
               and sl["cost_mapping"] == PAIR_STEPS
               and all(np.isfinite(r["losses"])),
               f"14(b) rank {r['rank']}: launches over {PAIR_STEPS} steps "
               f"{sl}, losses {r['losses']}")
    _check(r0["render_group"] == (0, 1) and r0["render_finite"]
           and (r0["render_equal"] or r0["render_share"] >= MS_DEPTH_SHARE),
           f"14(b): the sharded render against one process: equal "
           f"{r0['render_equal']}, {r0['render_share']} of the pixels within "
           f"{MS_DEPTH_TOL}")
    print(f"[multi] 14(b) two gloo ranks sharing the card (two processes on "
          f"one card, not scaling): the sharded step at 256 rays a rank vs "
          f"one process at 512: float32 loss {a['loss_rel']:.3g} relative, "
          f"gradients within rtol {STEP_GRAD_RTOL} atol {STEP_GRAD_ATOL} "
          f"(largest leaf {a['leaf_l2']:.3g}, whole {a['whole_l2']:.3g} in "
          f"L2); defaults loss {d['loss_rel']:.3g}, largest leaf "
          f"{d['leaf_l2']:.3g}, whole {d['whole_l2']:.3g} (bars "
          f"{BF16_LEAF_L2}, {BF16_WHOLE_L2}); replicas bit-equal "
          f"after {PAIR_STEPS} steps; launches a rank over {PAIR_STEPS} steps "
          f"{r0['step_launches']['fused_sdf']} fused SDF, "
          f"{r0['step_launches']['cost_mapping']} cost_mapping; median "
          f"{r0['median_ms']:.2f}/{r1['median_ms']:.2f} ms/step; sharded "
          f"576x768 render_depth {r0['render_s']:.3f} s (one process "
          f"{r0['single_render_s']:.3f} s), bit-equal "
          f"{r0['render_equal']}, max |diff| {r0['render_max_diff']:.3g}; "
          f"{seconds:.1f} s in all [{card}]", flush=True)
    return {"launches": [r0["launches"], r1["launches"]], "ranks": [r0, r1]}


def _recording(written: list, root: str):
    """Wrap the functions that write a scene's files, so that each
    call's path (relative to root) lands in `written`; returns what to
    restore."""
    from s_volsdf_tpu_torch.engine import fusion as fusion_mod
    from s_volsdf_tpu_torch.engine import runner as runner_mod
    from s_volsdf_tpu_torch.engine import trainer as trainer_mod
    patched = []
    for mod, name in ((runner_mod, "save_pfm"), (runner_mod, "write_png"),
                      (runner_mod, "write_cam"), (runner_mod, "save_config"),
                      (trainer_mod, "save_config"), (trainer_mod, "write_png"),
                      (ckpt, "save_state"), (fusion_mod, "save_ply")):
        fn = getattr(mod, name)

        def wrapper(*a, _fn=fn, **k):
            path = a[0] if isinstance(a[0], str) else a[1]
            written.append(os.path.relpath(path, root))
            return _fn(*a, **k)
        setattr(mod, name, wrapper)
        patched.append((mod, name, fn))
    return patched


def cli_rank(argv, root: str) -> Dict:
    """What each of 14(c)'s ranks runs: cli.run.main, recording the
    files it writes, stage 0's outputs, the launches and the log."""
    from s_volsdf_tpu_torch.engine import runner as runner_mod
    written, stage0, lines = [], [], []
    patched = _recording(written, root)
    run_stage = runner_mod.run_mvs_stage

    def spy(cfg, engine, sc, stage_idx):
        outs, extras = run_stage(cfg, engine, sc, stage_idx)
        if stage_idx == 0:
            stage0.extend({k: np.asarray(o[k]) if not torch.is_tensor(o[k])
                           else o[k].cpu().numpy()
                           for k in ("depth", "photometric_confidence",
                                     "prob_volume")} for o in outs)
        return outs, extras
    runner_mod.run_mvs_stage = spy
    handler = logging.Handler()
    handler.emit = lambda record: lines.append(record.getMessage())
    log = logging.getLogger("s_volsdf_tpu_torch")
    log.addHandler(handler)
    level = log.level
    log.setLevel(logging.INFO)
    _reset_counts()
    try:
        plys = cli_run.main(argv)
        torch.cuda.synchronize()
    finally:
        log.removeHandler(handler)
        log.setLevel(level)
        runner_mod.run_mvs_stage = run_stage
        for mod, name, fn in patched:
            setattr(mod, name, fn)
    return {"rank": pmesh.topology().rank, "written": written,
            "stage0": stage0, "plys": plys, "launches": _launch_counts(),
            "log": lines}


def cli_ranks(dev, card: str, tmp: str) -> Dict:
    """Phase 14(c): cli.run under three gloo ranks on the card, on phase
    7(d)'s 64x96 DTU fixture, 30 float32 steps of 510 rays (3 x 170):
    stage 0 one view a rank within STAGE_TOL of a one-process stage 0;
    ray-sharded training; every PFM, PNG and PLY written once, from the
    first rank, with finite depths."""
    small = os.path.join(tmp, "small")
    if not os.path.isdir(os.path.join(small, "DTU")):
        make_dtu_fixture(small, scan_id=int(SCAN[4:]), img_res=SMALL_RES)
    root = os.path.join(tmp, "multi_cli")
    out = os.path.join(root, "out")
    argv = small_run_args(tmp, out) + [
        f"exps_folder={os.path.join(root, 'exps')}",
        f"opt_stepNs=[{CLI_STEPS},0,0]", f"train.num_pixels={CLI_PIXELS}",
        "train.train_compute_dtype=float32",
        "train.train_activation_dtype=float32",
        "train.mvs_pack_dtype=float32", "mvs.compute_dtype=float32"]
    t0 = time.perf_counter()
    rs = pmesh.run_local_ranks(cli_rank, CLI_RANKS, argv, root,
                               device="cuda:0", backend="gloo",
                               timeout=RANK_TIMEOUT)
    seconds = time.perf_counter() - t0
    # Stage 0 in this process, with the same (seeded) cascade weights.
    cfg = load_config("dtu", [a for a in argv if "=" in a])
    engine = MVSEngine(cfg, device=dev)
    sc = setup_scene(cfg, SCAN, exps_root=os.path.join(root, "single"),
                     device=dev)
    outs, _ = run_mvs_stage(cfg, engine, sc, 0)
    stage_err = 0.0
    for r in rs:
        for got, want in zip(r["stage0"], outs):
            for k in got:
                w = want[k] if not torch.is_tensor(want[k]) \
                    else want[k].cpu().numpy()
                stage_err = max(stage_err, float(np.abs(got[k] - w).max()))
    _check(stage_err <= STAGE_TOL and all(len(r["stage0"]) == 3 for r in rs),
           f"14(c): stage 0 one view a rank against one process: "
           f"{stage_err:.3g}")
    _check(all(r["written"] == [] for r in rs[1:]),
           f"14(c): ranks other than the first wrote "
           f"{[r['written'] for r in rs[1:]]}")
    outputs = [p for p in rs[0]["written"] if "checkpoints" not in p]
    _check(len(outputs) == len(set(outputs)),
           f"14(c): files written more than once: {outputs}")
    pfms = [p for p in outputs if p.endswith(".pfm")]
    pngs = [p for p in outputs if p.endswith(".png")]
    plys = [p for p in outputs if p.endswith(".ply")]
    _check(len(pfms) == 6 and len(plys) == 1 and len(pngs) >= 9,
           f"14(c): outputs {outputs}")
    for p in pfms:
        d = read_pfm(os.path.join(root, p))[0]
        _check(np.isfinite(d).all(), f"14(c): non-finite {p}")
    sharded = [any(f"ray-sharded training over {CLI_RANKS} ranks" in x
                   for x in r["log"]) for r in rs]
    _check(all(sharded), f"14(c): ray-sharded training on the ranks {sharded}")
    for r in rs:
        _check(r["launches"]["cost_mapping"] == CLI_STEPS,
               f"14(c) rank {r['rank']}: launches {r['launches']}")
    print(f"[multi] 14(c) cli.run under {CLI_RANKS} gloo ranks on the card "
          f"at {SMALL_RES[0]}x{SMALL_RES[1]}, {CLI_STEPS} float32 steps of "
          f"{CLI_PIXELS} rays ({CLI_PIXELS // CLI_RANKS} a rank): stage 0 one "
          f"view a rank within {stage_err:.3g} of one process; ray-sharded "
          f"training; {len(pfms)} PFMs, {len(pngs)} PNGs, {len(plys)} PLY "
          f"written once by the first rank, finite depths; launches a rank "
          f"{[r['launches']['fused_sdf'] for r in rs]} fused SDF, "
          f"{[r['launches']['cost_mapping'] for r in rs]} cost_mapping, "
          f"{[r['launches']['geo_consistency'] for r in rs]} geo_consistency;"
          f" {seconds:.1f} s [{card}]", flush=True)
    return {"launches": [r["launches"] for r in rs]}


def _sum_launches(counts) -> Dict:
    """Per-kernel launch totals of several `_launch_counts` records."""
    return {"fused_sdf": {m: sum(c["fused_sdf"][m] for c in counts)
                          for m in fused_sdf.MODES},
            "cost_mapping": sum(c["cost_mapping"] for c in counts),
            "deform_conv": sum(c["deform_conv"] for c in counts),
            "geo_consistency": sum(c["geo_consistency"] for c in counts)}


def validate_cli_config(root: str) -> Config:
    """The config cli.run builds from ms_cli_args (the joint run's)."""
    from s_volsdf_tpu_torch.config import load_config, validate_config
    preset, extra = cli_run.parse_overrides(ms_cli_args(root, "joint"))
    return validate_config(load_config(
        preset, overrides=[f"{k}={v}" for k, v in extra.items()]))


# --------------------------------------------------------------------------
# Phase 15: the reference's checkpoints converted here, and the production
# schedule with its kill, resume and close-out
# --------------------------------------------------------------------------

MVS_MODELS = ("casmvsnet", "ucsnet", "transmvsnet")
WN_STYLES = ("weight_norm", "parametrizations")
LPIPS_TOL = 1e-5          # LPIPS on the card against the CPU's
# 15(b): chunks of 5 steps, so a checkpoint every 200 steps; the kill
# after step 250 leaves 200, and the resume replays 205-250.
PROD_CHUNK, PROD_CRASH, PROD_TARGET = 5, 250, 300
PROD_KILL_CODE = 17
# 15(c): two of the fixture's seven held-out views rendered and scored (a
# 576x768 `render_image` takes about 11 s; the long run scores all seven).
PROD_EVAL_VIEWS = 2
# A replayed row equals the killed run's but for these (the first row of
# each process also names the card).
ROW_CLOCK_KEYS = ("chunk_s", "wall", "phase", "card")
REPO_ROOT = os.path.dirname(os.path.abspath(__file__))


def _port_command(module: str, args) -> list:
    """A `python -m module args` command line run from the repository's
    root, in which `import jax` fails."""
    return [sys.executable, "-c",
            "import runpy, sys; sys.modules['jax'] = None; "
            f"runpy.run_module({module!r}, run_name='__main__', "
            "alter_sys=True)", *args]


def seeded_reference_trees(cfg: Config) -> Dict[str, Dict]:
    """The weight trees phase 15(a) writes as the reference's
    checkpoints: the three cascades at cfg's widths from seed 0 (their
    convs at He's gain, TransMVSNet's DCN offset convs random, so that
    stage 0 is not uniform and its DCNs sample off the grid), LPIPS from
    seed 0 and the dtu VolSDF field from seed 0."""
    trees = {}
    for model in MVS_MODELS:
        mcfg = copy.deepcopy(cfg)
        mcfg.mvs.model_name = model
        net = MVSEngine(mcfg, device="cpu").net
        he_gain(net)
        random_offsets(net)
        trees[model] = to_jax_mvs_params(net)
    trees["lpips"] = init_lpips_params(np.random.default_rng(0))
    trees["volsdf"] = to_jax_params(init_volsdf_params(
        torch.Generator().manual_seed(0), cfg.model))
    return trees


def _named_leaves(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """The leaves of a tree of dicts and lists by their paths."""
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_named_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def _equal_trees(got, want, what: str) -> int:
    """Every leaf of `got` equals the leaf of the same name in `want` in
    dtype, shape and bits; returns the leaf count."""
    a, b = _named_leaves(got), _named_leaves(want)
    _check(set(a) == set(b), f"{what}: leaves {sorted(set(a) ^ set(b))[:5]}"
           f" in one tree only")
    for name, y in b.items():
        x = a[name]
        _check(x.dtype == y.dtype and x.shape == y.shape
               and np.array_equal(x, y),
               f"{what}: leaf {name} {x.dtype}{x.shape} differs from "
               f"{y.dtype}{y.shape}")
    return len(b)


def _lpips_tree(model) -> Dict:
    """An LPIPS module's weights as the JAX tree (HWIO kernels)."""
    convs = iter({"b": b.detach().cpu().numpy(),
                  "w": w.detach().cpu().numpy().transpose(2, 3, 1, 0)}
                 for w, b in zip(model.weights, model.biases))
    return {"features": [[next(convs) for _ in block] for block in VGG_PLAN],
            "lins": [{"w": w.detach().cpu().numpy()} for w in model.lins]}


def convert_checkpoints(tmp: str, trees: Dict[str, Dict]) -> Dict:
    """Phase 15(a)'s conversions: each tree written as the reference's
    checkpoint ({"epoch", "model", "optimizer"}; VolSDF's bare state
    dict, in both weight-norm key styles) with torch.save, then converted
    by `python -m s_volsdf_tpu_torch.tools.convert_ckpt` in processes
    without JAX, all at once. Returns {name: converted directory} and
    the seconds."""
    jobs = {}
    for model, tree in trees.items():
        styles = WN_STYLES if model == "volsdf" else (None,)
        for style in styles:
            name = model if style is None else f"volsdf_{style}"
            src = os.path.join(tmp, f"{name}.ckpt")
            if style is None:
                torch.save(reference_checkpoint(model, tree), src)
            else:
                torch.save(reference_state_dict(model, tree, wn_style=style),
                           src)
            jobs[name] = (model, src, os.path.join(tmp, f"{name}_converted"))
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        _port_command("s_volsdf_tpu_torch.tools.convert_ckpt",
                      ["--model", model, "--ckpt", src, "--out", out]),
        cwd=REPO_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for name, (model, src, out) in jobs.items()}
    for name, p in procs.items():
        out, err = p.communicate(timeout=300)
        _check(p.returncode == 0,
               f"convert_ckpt {name}: rc {p.returncode}\n{err[-2000:]}")
    seconds = time.perf_counter() - t0
    dirs = {name: out for name, (_, _, out) in jobs.items()}
    for name, d in dirs.items():
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        _check(meta == {"model": jobs[name][0]}, f"{name} meta {meta}")
    return {"dirs": dirs, "seconds": seconds}


def converted_cascades(dev, card: str, tmp: str, trees: Dict,
                       dirs: Dict) -> Dict:
    """Phase 15(a): each cascade loaded from its converted directory on
    the card (every leaf equal to the source tree's) and on the CPU, and
    stage 0 of the first view of a 64x96 fixture on both, within phase
    6/9's float32 bars."""
    data_root = os.path.join(tmp, "convert_data")
    make_dtu_fixture(data_root, img_res=SMALL_RES)
    out = {}
    for model in MVS_MODELS:
        cfg = cascade_config(data_root, SMALL_RES, SMALL_NDEPTHS, False,
                             (0, 0, 0))
        cfg.mvs.model_name = model
        engine = MVSEngine(cfg, weights_path=dirs[model], device=dev)
        n = _equal_trees(to_jax_mvs_params(engine.net), trees[model],
                         f"{model} loaded on the card")
        cpu = MVSEngine(cfg, weights_path=dirs[model], device="cpu")
        sample = MVSDataset(
            datapath=os.path.join(data_root, "DTU", "mvs_data"), scan=SCAN,
            nviews=cfg.num_view, data_dir="DTU", ndepths=cfg.mvs.numdepth,
            interval_scale=cfg.mvs.interval_scale, max_h=cfg.max_h,
            max_w=cfg.max_w,
            trains_i=get_trains_ids("DTU", SCAN, cfg.num_view),
            data_dir_root=data_root, x2_mvsres=False)[0]
        launches = deform_conv.deform_conv2d.launches
        feats = engine.sample_features(engine.scene_feature_cache(sample.imgs),
                                      list(range(len(sample.view_ids))))
        got, _ = engine.stage(0, feats, sample.proj_matrices["stage1"],
                             sample.depth_values, None, None,
                             sample.imgs.shape[1:3], inverse_depth=False)
        dcn = deform_conv.deform_conv2d.launches - launches
        want_dcn = DCN_LAUNCHES_A_SCENE if model == "transmvsnet" else 0
        _check(dcn == want_dcn, f"{model} stage 0: {dcn} deform_conv "
               f"launches, want {want_dcn}")
        errs = stages_against_cpu(engine, sample, [got], cpu=cpu)
        ok = errs["prob"] <= PROB_TOL and errs["depth_rel"] <= DEPTH_RTOL
        if model == "transmvsnet":
            ok = ok and errs["wta"] == 0 and errs["conf"] <= PROB_TOL
        _check(ok, f"{model} stage 0 from converted weights, card vs CPU: "
               f"{errs}")
        print(f"[convert] {model}: {n} leaves loaded on the card equal to "
              f"the source; stage 0 at {SMALL_RES[0]}x{SMALL_RES[1]} card "
              f"vs CPU (both from {os.path.basename(dirs[model])}): prob "
              f"max|diff| {errs['prob']:.3e} (tol {PROB_TOL}), depth rel "
              f"{errs['depth_rel']:.3e} (tol {DEPTH_RTOL})"
              + (f", wta {errs['wta']}, conf {errs['conf']:.3e}"
                 if model == "transmvsnet" else "")
              + f"; {dcn} deform_conv launches [{card}]", flush=True)
        out[model] = errs
        del engine, cpu
    return out


def converted_lpips(dev, card: str, tmp: str, trees: Dict,
                    dirs: Dict) -> float:
    """Phase 15(a): LPIPS from its converted directory (leaves equal to
    the source), `eval_rendered_views` on two held-out views of a 64x96
    fixture (noisy copies of the ground truth as the renders) on the
    card against the CPU; returns the largest LPIPS difference."""
    d = dirs["lpips"]
    _equal_trees(_lpips_tree(load_lpips(d, dev)), trees["lpips"],
                 "lpips loaded on the card")
    root = os.path.join(tmp, "lpips_data")
    make_dtu_fixture(root, img_res=SMALL_RES, n_eval_views=2)
    scene = load_scene("DTU", SMALL_RES, 106, -1, root)
    images = os.path.join(tmp, "lpips_renders")
    rng = np.random.default_rng(3)
    for vid in scene.eval_ids()[:2]:
        gt = scene.rgb[vid].reshape(*SMALL_RES, 3)
        noisy = np.clip(gt + rng.normal(0, 0.05, gt.shape), 0, 1)
        write_png(os.path.join(images, f"eval_{vid:03d}.png"),
                  (noisy * 255).astype(np.uint8))
    cfg = dtu_config()
    got = eval_rendered_views(cfg, scene, images, "default", d, device=dev)
    want = eval_rendered_views(cfg, scene, images, "default", d,
                               device="cpu")
    err = abs(got["lpips_mean"] - want["lpips_mean"])
    _check(got["n_views"] == 2 and np.isfinite(got["lpips_mean"])
           and err <= LPIPS_TOL,
           f"LPIPS from converted weights: card {got}, CPU {want}")
    print(f"[convert] lpips: leaves equal to the source; LPIPS of 2 "
          f"held-out 64x96 views on the card {got['lpips_mean']:.6f}, CPU "
          f"{want['lpips_mean']:.6f}, |diff| {err:.2e} (tol {LPIPS_TOL}) "
          f"[{card}]", flush=True)
    return err


def converted_volsdf(dev, card: str, trees: Dict, dirs: Dict) -> float:
    """Phase 15(a): the VolSDF field from each weight-norm key style's
    converted directory (leaves equal to the source), and the fused SDF
    kernel on it against its plain version at 65,536 points (float32
    mode, KERNEL_TOL); returns the largest difference."""
    cfg = dtu_config()
    template = init_volsdf_params(torch.Generator().manual_seed(1),
                                  cfg.model)
    worst = 0.0
    for style in WN_STYLES:
        params = load_volsdf_checkpoint(dirs[f"volsdf_{style}"], template,
                                        dev)
        n = _equal_trees(to_jax_params(params), trees["volsdf"],
                         f"volsdf ({style}) loaded")
        pts = torch.as_tensor(np.random.default_rng(1).normal(
            size=(KERNEL_SWEEP, 3)).astype(np.float32), device=dev)
        got = fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0)
        ref = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts, 3.0)
        err = torch.max(torch.abs(got - ref)).item()
        _check(err <= KERNEL_TOL, f"fused SDF on converted VolSDF weights "
               f"({style}): {err} > {KERNEL_TOL}")
        worst = max(worst, err)
        print(f"[convert] volsdf ({style} keys): {n} leaves equal to the "
              f"source; fused SDF kernel vs plain at {KERNEL_SWEEP} pts "
              f"max|diff| {err:.3e} (tol {KERNEL_TOL}) [{card}]", flush=True)
    return worst


def _rows(path: str):
    rows, done = [], None
    with open(path) as f:
        for line in f:
            rec = json.loads(line)
            if rec.get("done"):
                done = rec
            else:
                rows.append(rec)
    return rows, done


def production_run(dev, card: str, tmp: str) -> Dict:
    """Phase 15(b): `tools.run_100k` at the dtu preset, full widths,
    576x768: a process killed after step PROD_CRASH (exit code 17, no
    kill-site checkpoint), then `--resume` in this process to
    PROD_TARGET. The replayed rows equal the killed run's in every field
    but the clock's, no guard trips, a finite radial error."""
    exps = os.path.join(tmp, "run100k")
    args = ["--exps", exps, "--chunk", str(PROD_CHUNK),
            "--target", str(PROD_TARGET)]
    t0 = time.perf_counter()
    kill = subprocess.run(
        _port_command("s_volsdf_tpu_torch.tools.run_100k",
                      args + ["--crash-at", str(PROD_CRASH)]),
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=900)
    kill_s = time.perf_counter() - t0
    _check(kill.returncode == PROD_KILL_CODE,
           f"run_100k --crash-at {PROD_CRASH}: rc {kill.returncode}, want "
           f"{PROD_KILL_CODE}\n{kill.stdout[-2000:]}\n{kill.stderr[-3000:]}")
    t0 = time.perf_counter()
    res = run_100k.main(args + ["--resume"], device=dev)
    resume_s = time.perf_counter() - t0
    rows, done = _rows(os.path.join(exps, "run100k.jsonl"))
    initial = {r["step"]: r for r in rows if r["phase"] == "initial"}
    resumed = {r["step"]: r for r in rows if r["phase"] == "resume"}
    ckpt_step = PROD_CRASH - PROD_CRASH % (PROD_CHUNK * 40)
    replayed = list(range(ckpt_step + PROD_CHUNK, PROD_CRASH + 1,
                          PROD_CHUNK))
    _check(max(initial) == PROD_CRASH and min(resumed) == replayed[0]
           and max(resumed) == PROD_TARGET,
           f"rows: killed run to {max(initial)}, resume "
           f"{min(resumed)}-{max(resumed)}")
    for step in replayed:
        a = {k: v for k, v in initial[step].items()
             if k not in ROW_CLOCK_KEYS}
        b = {k: v for k, v in resumed[step].items()
             if k not in ROW_CLOCK_KEYS}
        _check(a == b, f"replayed row {step}: {b} != killed run's {a}")
    radial = [r["mean_mm"] for r in done["radial_error"].values()]
    _check(done["steps"] == PROD_TARGET and done["guard_trips"] == 0
           and all(r["guard_trips"] == 0 for r in rows)
           and all(np.isfinite(radial)) and card in done["card"],
           f"run_100k done record {done}")
    med = float(np.median([r["chunk_s"] for r in rows]))
    first = resumed[replayed[0]]
    setup_s = first["wall"] - first["chunk_s"]
    print(f"[run100k] run_100k dtu 576x768 full widths, chunks of "
          f"{PROD_CHUNK}: killed after step {PROD_CRASH} (rc "
          f"{kill.returncode}, {kill_s:.1f} s), resumed from {ckpt_step} "
          f"to {PROD_TARGET} ({resume_s:.1f} s); rows {replayed[0]}-"
          f"{replayed[-1]} of both runs equal but for their clocks; guard "
          f"trips 0; median chunk {med:.3f} s ({1e3 * med / PROD_CHUNK:.1f} "
          f"ms/step); resume set-up {setup_s:.1f} s; "
          f"feedback renders {done['feedback_render_s']} s; radial error "
          f"(mm) {[round(r, 3) for r in radial]}; last loss "
          f"{rows[-1]['loss']}, PSNR {rows[-1]['psnr']} [{card}]",
          flush=True)
    return {"exps": exps, "median_chunk_s": med, "done": done,
            "kill_s": kill_s, "resume_s": resume_s, "setup_s": setup_s}


def production_close_out(dev, card: str, tmp: str, exps: str) -> Dict:
    """Phase 15(c): `tools.run_flagship` on 15(b)'s run: finite Chamfer,
    PSNR and SSIM, fused points."""
    t0 = time.perf_counter()
    out = run_flagship.main(["--exps", exps, "--out",
                             os.path.join(tmp, "flagship.json"),
                             "--n-eval", str(PROD_EVAL_VIEWS)], device=dev)
    seconds = time.perf_counter() - t0
    nvs = out["nvs"]
    _check(out["step"] == PROD_TARGET and out["n_fused_points"] > 0
           and np.isfinite(out["chamfer_mm"]["overall"])
           and np.isfinite(nvs["psnr_mean"]) and np.isfinite(nvs["ssim_mean"])
           and nvs["n_views"] == PROD_EVAL_VIEWS,
           f"run_flagship: {out}")
    print(f"[flagship] run_flagship at step {out['step']}: "
          f"{out['n_fused_points']} fused points, Chamfer "
          f"{out['chamfer_mm']} mm, radial {out['radial_mm']} mm, PSNR "
          f"{nvs['psnr_mean']:.3f}, SSIM {nvs['ssim_mean']:.4f} over "
          f"{nvs['n_views']} held-out views; {seconds:.1f} s (depth "
          f"renders {out['wall_s']['depth_renders']} s, eval renders "
          f"{out['wall_s']['eval_renders']} s) [{card}]", flush=True)
    return {"seconds": seconds, "out": out}


# Phase 16: the paired stream of tests/test_torch_trajectory.py on the
# card, held to the CPU port's, then the card alone across the anneal.
TRAJ_PAIRED = 10     # steps held to the CPU port's, step by step
TRAJ_STEPS = 300     # the card's steps in all (anneal_rgb is 200)
TRAJ_EVERY = 50
# Step 1 on the card against step 1 on the CPU: each term within these
# (relative to the larger; the PSNR in dB). One program on the two
# devices read 7.7e-5 / 2.3e-5 / 1.4e-4 / 2.6e-4 / 6.5e-7 / 1.8e-5 dB /
# 7.9e-4 (loss / RGB / eikonal / MVS / sparse / PSNR / gradient norm;
# PERF.md, PR 15, from the JAX package's seed-0 init); a sampler sweep
# that rounds its softplus once where the step's MLP rounds it op by op
# (the port before PR 15, against the JAX package) 4.4e-3 / 3.4e-5 /
# 6.2e-4 / 1.7e-3 / 7.8e-3 / 9.7e-5 dB / 5.2e-3, past the loss, MVS and
# sparse bars. From step 2 on, bf16 roundings that the sums' order moves
# and Adam's first steps carry put each term 1e-3 to 1e-2 apart.
TRAJ_STEP1_BARS = {"loss": 1e-3, "rgb_loss": 1e-3, "eikonal_loss": 5e-3,
                   "mvs_loss": 1e-3, "sparse_loss": 1e-3, "psnr": 0.01,
                   "grad_norm": 5e-3}
# Steps 1-TRAJ_PAIRED within trajectory.BARS["defaults"] on the terms
# that one gated ray's flip does not jump. The RGB term and the PSNR are
# reported, not held: from the JAX package's init one ray's confidence
# crosses the gate's 1e-8 at step 6-8 on one device and not the other,
# moving them 5.6e-2 and 0.25 dB (PERF.md, PR 15), past their bars.
TRAJ_HELD = ("loss", "eikonal_loss", "mvs_loss", "sparse_loss")
# The plateau leg: the JAX package's own loop at seed 2 after step 250,
# on the post-anneal colour plateau (PERF.md §6), its whole
# TrainState carried into the port by name on the CPU and on the card;
# step 1 from it held within TRAJ_STEP1_BARS, then PLATEAU_STEPS steps
# on the card.
PLATEAU_STATE = os.path.join("runs_torch", "plateau_jax_seed2_s250.npz")
PLATEAU_STEPS = 100
# Every step of both packages from PLATEAU_STATE on the stream of seed 0
# at the defaults (tests/test_torch_trajectory.py paired --from-state,
# on the CPU): the JAX package's step 1 is the leg's first batch. The
# leg holds the card's eikonal term there within
# TRAJ_STEP1_BARS["eikonal_loss"] of it: with the softplus derivative
# autograd took of its three ops (the port at 19839b1) the CPU's was
# 8.9e-3 from it (PERF.md §6).
PLATEAU_JAX_ROWS = os.path.join("runs_torch",
                                "traj_plateau_paired_defaults_every_cpu.json")


def plateau_leg(dev, card: str, cpu: Dict, card_su: Dict) -> Dict:
    """Phase 16's plateau leg: PLATEAU_STATE into the port's trainers on
    the CPU and on the card (`read_named_state`: every leaf by name);
    step 1 from it, on one batch of the stream of seed 0, on the card
    held to the CPU's within TRAJ_STEP1_BARS on every term, and its
    eikonal term to the JAX package's (PLATEAU_JAX_ROWS) within that
    term's bar; then the card alone for PLATEAU_STEPS steps of that
    stream, its RGB L1 and PSNR printed at steps 50 and 100 with the
    escape step (the first step under `trajectory.ESCAPE_RGB`), if any.
    Returns its launch counts."""
    t0 = time.perf_counter()
    here = os.path.dirname(os.path.abspath(__file__))
    for su in (cpu, card_su):
        ckpt.read_named_state(os.path.join(here, PLATEAU_STATE),
                              su["trainer"].state)
    with open(os.path.join(here, PLATEAU_JAX_ROWS)) as f:
        jax_step1 = json.load(f)["jax"][0]
    start = card_su["trainer"].state.iter_step
    batches = list(trajectory.stream(cpu["cfg"], cpu["scene_cpu"],
                                     PLATEAU_STEPS, 0))
    tr = cpu["trainer"]
    want = trajectory.run_port(cpu["cfg"], tr.state, tr.tx, cpu["mvs"],
                               batches[:1], "cpu")
    tr = card_su["trainer"]
    _reset_counts()                             # the leg's path starts
    t1 = time.perf_counter()
    rows = trajectory.run_port(card_su["cfg"], tr.state, tr.tx,
                               card_su["mvs"], batches, dev)
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t1
    counts = _launch_counts()                   # ... and ends here
    step1 = {k: trajectory.diff(k, rows[0][k], want[0][k])
             for k in TRAJ_STEP1_BARS}
    _check(jax_step1["step"] == rows[0]["step"],
           f"{PLATEAU_JAX_ROWS} starts at {jax_step1['step']}, the leg at "
           f"{rows[0]['step']}")
    eik = trajectory.diff("eikonal_loss", rows[0]["eikonal_loss"],
                          jax_step1["eikonal_loss"])
    escape = next((r["step"] for r in rows
                   if r["rgb_loss"] < trajectory.ESCAPE_RGB), None)
    at = {r["step"] - start: r for r in rows}
    print(f"[trajectory] plateau leg from {PLATEAU_STATE} (iter_step "
          f"{start}): step 1 card vs CPU {step1} against "
          f"{TRAJ_STEP1_BARS}; eikonal term card vs the JAX package "
          f"{eik:.3e} ({rows[0]['eikonal_loss']:.6f} against "
          f"{jax_step1['eikonal_loss']:.6f}); " + "; ".join(
              f"step {n} (iter {start + n}): rgb {at[n]['rgb_loss']:.5f} "
              f"PSNR {at[n]['psnr']:.3f}" for n in (50, 100))
          + f"; escape step {escape} [{card}]", flush=True)
    _check(all(step1[k] <= bar for k, bar in TRAJ_STEP1_BARS.items()),
           f"plateau leg, card vs CPU at step 1: {step1} past "
           f"{TRAJ_STEP1_BARS}")
    _check(eik <= TRAJ_STEP1_BARS["eikonal_loss"],
           f"plateau leg, the eikonal term at step 1 {eik} from the JAX "
           f"package's, past {TRAJ_STEP1_BARS['eikonal_loss']}")
    for r in rows:
        _check(r["grad_finite"] == 1.0 and np.isfinite(r["loss"]),
               f"plateau leg step {r['step']}: {r}")
    _check(counts["fused_sdf"]["bfloat16"] == PLATEAU_STEPS
           and counts["cost_mapping"] == PLATEAU_STEPS,
           f"plateau leg launches {counts}: want {PLATEAU_STEPS} bf16 "
           f"fused SDF and {PLATEAU_STEPS} cost_mapping, one each a step")
    print(f"[trajectory] plateau leg in {time.perf_counter() - t0:.2f} s "
          f"({PLATEAU_STEPS} card steps in {card_s:.1f} s) [{card}]",
          flush=True)
    return counts


def trajectory_on_card(dev, card: str, tmp: str) -> Dict:
    """Phase 16: `tools.trajectory`'s stream (the port's draws from a CPU
    generator) through the port's step at the dtu defaults, full width,
    on the 192x256 fixture with the GT prior: TRAJ_PAIRED steps on the
    CPU and the same on the card from the same init; step 1 held within
    TRAJ_STEP1_BARS on every term, the RGB term and the PSNR included,
    steps 1-TRAJ_PAIRED within `trajectory.BARS["defaults"]` on
    TRAJ_HELD, the RGB term's and the PSNR's worst and parting step
    printed; then the card alone to TRAJ_STEPS, a [trajectory] line every
    TRAJ_EVERY steps. Returns the card run's launch counts."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "trajectory")
    cpu = trajectory.setup(root, device="cpu")
    batches = list(trajectory.stream(cpu["cfg"], cpu["scene_cpu"],
                                     TRAJ_STEPS, 0))
    tr = cpu["trainer"]
    want = trajectory.run_port(cpu["cfg"], tr.state, tr.tx, cpu["mvs"],
                               batches[:TRAJ_PAIRED], "cpu")
    cpu_s = time.perf_counter() - t0
    card_su = trajectory.setup(root, device=dev)
    tr = card_su["trainer"]
    _reset_counts()                             # the phase 16 path starts
    t1 = time.perf_counter()
    rows = trajectory.run_port(card_su["cfg"], tr.state, tr.tx,
                               card_su["mvs"], batches, dev)
    torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t1
    counts = _launch_counts()                   # ... and ends here
    step1 = {k: trajectory.diff(k, rows[0][k], want[0][k])
             for k in TRAJ_STEP1_BARS}
    bars = trajectory.BARS["defaults"]
    worst = {k: max(trajectory.diff(k, a[k], b[k])
                    for a, b in zip(rows, want)) for k in bars}
    parted = trajectory.parted(rows, want, bars)
    print(f"[trajectory] card vs CPU at the defaults: step 1 {step1} "
          f"against {TRAJ_STEP1_BARS}; worst of {TRAJ_PAIRED} steps "
          f"{worst}, held on {list(TRAJ_HELD)} against {bars} (the RGB "
          f"term and the PSNR part at {parted['rgb_loss']} / "
          f"{parted['psnr']}, reported); the CPU's steps {cpu_s:.1f} s "
          f"with set-up", flush=True)
    _check(all(step1[k] <= bar for k, bar in TRAJ_STEP1_BARS.items()),
           f"card vs CPU at step 1: {step1} past {TRAJ_STEP1_BARS}")
    _check(all(parted[k] is None for k in TRAJ_HELD),
           f"card vs CPU trajectory parted at {parted}")
    for r in rows:
        _check(r["grad_finite"] == 1.0 and np.isfinite(r["loss"]),
               f"trajectory step {r['step']}: {r}")
        if r["step"] % TRAJ_EVERY == 0:
            print(f"[trajectory] step {r['step']}: rgb {r['rgb_loss']:.5f} "
                  f"PSNR {r['psnr']:.3f} beta {r['beta']:.6f} eik "
                  f"{r['eikonal_loss']:.5f} mvs {r['mvs_loss']:.5f} [{card}]",
                  flush=True)
    _check(counts["fused_sdf"]["bfloat16"] == TRAJ_STEPS
           and counts["cost_mapping"] == TRAJ_STEPS,
           f"phase 16 launches {counts}: want {TRAJ_STEPS} bf16 fused SDF "
           f"and {TRAJ_STEPS} cost_mapping, one each a step")
    print(f"[trajectory] phase 16 in {time.perf_counter() - t0:.2f} s: "
          f"{TRAJ_STEPS} card steps in {card_s:.1f} s "
          f"({1e3 * card_s / TRAJ_STEPS:.1f} ms a step with the stream's "
          f"copies); launches {counts} [{card}]", flush=True)
    leg = plateau_leg(dev, card, cpu, card_su)
    del cpu, card_su, tr
    torch.cuda.empty_cache()
    return {"fused_sdf": {m: counts["fused_sdf"][m] + leg["fused_sdf"][m]
                          for m in counts["fused_sdf"]},
            "cost_mapping": counts["cost_mapping"] + leg["cost_mapping"]}


def main() -> None:
    start = time.perf_counter()
    # 1. Environment.
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU only",
              file=sys.stderr)
        sys.exit(1)
    dev = torch.device("cuda")
    card = card_name(dev)
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}; TF32 flags (left as they "
          f"are): cuDNN {torch.backends.cudnn.allow_tf32}, matmul "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    print(f"[env] card: {card}", flush=True)

    # 2. Build, every source at once.
    def timed(build):
        t0 = time.perf_counter()
        build(force=True)
        return time.perf_counter() - t0

    t0 = time.perf_counter()
    sources = {"csrc/fused_sdf.cu": fused_sdf.build,
               "csrc/cost_mapping.cu": cost_mapping.build,
               "csrc/fusion.cu": geo_consistency.build,
               "csrc/deform_conv.cu": deform_conv.build,
               "csrc/downsample.cpp": eval_geo.build_downsample,
               "csrc/mc.cpp": mesh_mod.build_mc}
    with ThreadPoolExecutor(len(sources)) as pool:
        build_s = dict(zip(sources, pool.map(timed, sources.values())))
    print("[build] " + ", ".join(f"{k} {v:.2f} s" for k, v in build_s.items())
          + f"; all in {time.perf_counter() - t0:.2f} s", flush=True)

    # 3. The kernels against their plain versions, full width.
    sdf = check_fused_sdf(dev, card)
    cost = check_cost_mapping(dev, card)
    dcn = check_deform_conv(dev, card)

    with tempfile.TemporaryDirectory() as tmp:
        # 4, 5. Training at bench.py's shapes, then the feedback renders.
        trainers, launches = run_training(dev, card, tmp)
        outside = run_outside_family(dev, card, trainers["defaults"])
        check_render_on_cpu(trainers["float32"])
        near = check_near_surface(trainers["float32"])
        for mode, err in near.items():
            sdf[mode]["errs"]["near_surface"] = err

        # 8(a)-(c). Evaluation on the float32 trainer before it goes: the
        # launch counts set to 0 here and read after (c).
        _reset_counts()
        trainer = trainers["float32"]
        eval_round_trip(dev, card, trainer, tmp)
        eval_render(dev, card, trainer)
        mesh = eval_mesh(dev, card, trainer, tmp)
        sdf["float32"]["errs"]["mesh_subgrid"] = mesh["subgrid_err"]
        eval_field = _launch_counts()
        print(f"[eval] launches on the trained field's evaluation path: "
              f"{eval_field}", flush=True)
        del trainers, trainer

        # 6. The cascade and the scene runner; 7. fusion and evaluation on
        # its outputs; 8(d), (e) on both.
        scene_launches, res, data_root = run_cascade(dev, card, tmp)
        fusion = run_fusion(dev, card, tmp, res, data_root)
        _reset_counts()
        eval_scene_views(dev, card, tmp, res)
        eval_command_lines(dev, card, tmp)
        eval_cli = _launch_counts()
        print(f"[eval] launches on the scene and command-line evaluation "
              f"path: {eval_cli}", flush=True)
        del res

        # 9. The other cascades: UCSNet and TransMVSNet.
        other = run_other_cascades(dev, card, tmp, data_root)

        # 11. BlendedMVS: the unclamped kernel, the background step, a
        # scene, its eval.
        unclamped = check_unclamped(dev, card)
        for mode, u in unclamped.items():
            sdf[mode]["errs"]["unclamped"] = u["err"]
        bmvs = [run_bmvs_training(dev, card), run_bmvs_scene(dev, card, tmp)]
        bmvs_sdf = {m: sum(p["fused_sdf"][m] for p in bmvs)
                    for m in fused_sdf.MODES}
        print(f"[bmvs] fused SDF launches at bounding_sphere 0 on the "
              f"BlendedMVS paths: {bmvs_sdf}", flush=True)

        # 12. The image path: the JPEG scene phase 11 read, IBR at full
        # size, the command-line chain at 64x96.
        t0 = time.perf_counter()
        jpeg = check_jpeg_scene(card, tmp)
        _reset_counts()                         # the IBR paths start
        ibr = run_ibr(dev, card, tmp)
        ibr_cli = ibr_command_lines(dev, card, tmp)
        ibr_launches = _launch_counts()         # ... and end here
        check_ibr_view(dev, card, ibr)
        want = IBR_GEO_LAUNCHES * (ibr["views"] + ibr_cli["views"])
        _check(ibr_launches["geo_consistency"] == want,
               f"IBR geo_consistency launches {ibr_launches}, want {want}")
        print(f"[image] phase 12 in {time.perf_counter() - t0:.2f} s: JPEG "
              f"decode {jpeg['decode_ms']:.3f} ms/image, IBR "
              f"{ibr['s_per_view']:.4f} s/view; launches on the IBR paths "
              f"{ibr_launches} [{card}]", flush=True)

        # 13. Multi-scene training in lockstep: the scene axis of both
        # kernels, the lockstep step at full width, the command line.
        t0 = time.perf_counter()
        ms_data = ms_scenes(dev)
        axis = check_scene_axis(dev, card, ms_data)
        _reset_counts()                         # the multi-scene paths start
        run_lockstep(dev, card, ms_data)
        ms_command_line(dev, card, tmp)
        ms_launches = _launch_counts()          # ... and end here
        del ms_data
        torch.cuda.empty_cache()
        print(f"[multiscene] phase 13 in {time.perf_counter() - t0:.2f} s; "
              f"launches on the multi-scene paths {ms_launches} [{card}]",
              flush=True)

        # 14. Multi-device on the one card: one NCCL rank in this
        # process, then spawned gloo ranks sharing the card.
        t0 = time.perf_counter()
        _reset_counts()                         # the multi-device paths start
        multi = {"a": one_nccl_rank(dev, card, tmp)}
        rank_launches = [_launch_counts()]      # ... (a) ends here
        multi["b"] = pair_ranks(card)
        multi["c"] = cli_ranks(dev, card, tmp)
        sharded = _sum_launches(rank_launches + multi["b"]["launches"]
                                + multi["c"]["launches"])
        print(f"[multi] phase 14 in {time.perf_counter() - t0:.2f} s; "
              f"launches on the multi-device paths (this process and the "
              f"spawned ranks) {sharded} [{card}]", flush=True)

        # 15. The reference's checkpoints converted on this machine, the
        # production schedule killed and resumed, its close-out.
        t0 = time.perf_counter()
        trees = seeded_reference_trees(float32_dtu_config())
        conv = convert_checkpoints(tmp, trees)
        print(f"[convert] {len(conv['dirs'])} reference checkpoints "
              f"converted by python -m s_volsdf_tpu_torch.tools.convert_ckpt"
              f" without JAX, in parallel, in {conv['seconds']:.1f} s",
              flush=True)
        converted_volsdf(dev, card, trees, conv["dirs"])
        _reset_counts()                         # the phase 15 paths start
        converted_cascades(dev, card, tmp, trees, conv["dirs"])
        converted_lpips(dev, card, tmp, trees, conv["dirs"])
        prod = production_run(dev, card, tmp)
        production_close_out(dev, card, tmp, prod["exps"])
        prod_launches = _launch_counts()        # ... and end here
        del trees
        torch.cuda.empty_cache()
        print(f"[production] phase 15 in {time.perf_counter() - t0:.2f} s; "
              f"launches on its paths in this process (the killed "
              f"run_100k process's are not counted) {prod_launches} "
              f"[{card}]", flush=True)

        # 16. The paired stream on the card against the CPU port, then
        # the card alone across the anneal.
        traj_launches = trajectory_on_card(dev, card, tmp)

    # 10. Results. Launches are summed over the paths, each counted from 0.
    paths = [launches, outside, scene_launches["float32"],
             scene_launches["defaults"],
             {"fused_sdf": fusion["sdf_launches"],
              "cost_mapping": fusion["cost_launches"]}, eval_field,
             eval_cli] + other + bmvs + [ibr_launches, ms_launches, sharded,
                                         prod_launches, traj_launches]
    sdf_launches = {m: sum(p["fused_sdf"][m] for p in paths)
                    for m in fused_sdf.MODES}
    cost_launches = sum(p["cost_mapping"] for p in paths)
    dcn_launches = sum(p.get("deform_conv", 0) for p in paths)
    geo_launches = fusion["launches"] + sum(p.get("geo_consistency", 0)
                                            for p in paths)
    grid_launches = sum(g["launches"] for k in ("high_res", "by_grid")
                        for g in mesh[k]["stats"]["grids"])
    def by_scenes(key):
        counts = ms_launches[key]
        return {str(k): counts[k] for k in sorted(counts)}
    lockstep_sdf = sum(n for k, n in ms_launches["fused_sdf_scenes"].items()
                       if k > 1)
    lockstep_cost = sum(n for k, n in
                        ms_launches["cost_mapping_scenes"].items() if k > 1)
    sdf16, sdf16_axis = sdf["bfloat16"], axis["fused_sdf_bfloat16"]
    print(f"[kernel] fused_sdf bfloat16 mode: "
          + ", ".join(f"{n} pts {sdf16['kernel_ms'][n]:.4f} ms ("
                      f"{100 * sdf16['bound_ms'][n] / sdf16['kernel_ms'][n]:.1f}"
                      f"% of bound)" for n in (KERNEL_SWEEP, KERNEL_RENDER))
          + f", {MS_SCENES} scenes x {KERNEL_SWEEP} pts in one launch "
          f"{sdf16_axis['ms']:.4f} ms ("
          f"{100 * sdf16_axis['bound_ms'] / sdf16_axis['ms']:.1f}% of bound) "
          f"[{card}]", flush=True)
    print(f"[kernels] launches on the paths driven: fused SDF {sdf_launches}, "
          f"cost_mapping {cost_launches}, geo_consistency {geo_launches}, "
          f"deform_conv {dcn_launches}", flush=True)
    kernels = []
    for mode, name in (("float32", "fused_sdf"), ("bfloat16", "fused_sdf_bf16")):
        m = sdf[mode]
        kernels.append({
            "name": name, "mode": mode, "route": "cuda",
            "source": "s_volsdf_tpu_torch/csrc/fused_sdf.cu",
            "replaces": "s_volsdf_tpu/ops/pallas/fused_sdf.py:116",
            "launches": sdf_launches[mode],
            "max_abs_err": max(m["errs"].values()),
            "ms": m["kernel_ms"][KERNEL_SWEEP], "plain_ms": m["plain_ms"],
            "bound_ms": m["bound_ms"][KERNEL_SWEEP],
            "bound_by": "operations", "library_ms": None,
            "unclamped_launches": bmvs_sdf[mode],
            "sharded_launches": sharded["fused_sdf"][mode],
            "production_launches": prod_launches["fused_sdf"][mode],
            "trajectory_launches": traj_launches["fused_sdf"][mode],
            "scene_launches": by_scenes("fused_sdf_scenes"),
            "lockstep_launches": lockstep_sdf,
            "scenes_ms": axis[f"fused_sdf_{mode}"]["ms"],
            "scenes_singles_ms": axis[f"fused_sdf_{mode}"]["singles_ms"],
            "scenes_bound_ms": axis[f"fused_sdf_{mode}"]["bound_ms"],
            "unclamped_ms": unclamped[mode]["ms"],
            "tflops": m["tflops"][KERNEL_SWEEP],
            f"ms_at_{KERNEL_RENDER}": m["kernel_ms"][KERNEL_RENDER],
            f"bound_ms_at_{KERNEL_RENDER}": m["bound_ms"][KERNEL_RENDER],
            **({"mesh_grid_launches": grid_launches}
               if mode == "float32" else {})})
    bf16 = cost["bfloat16"]
    kernels.append({
        "name": "cost_mapping", "route": "cuda",
        "source": "s_volsdf_tpu_torch/csrc/cost_mapping.cu",
        "replaces": "s_volsdf_tpu/ops/cost_mapping.py:152",
        "launches": cost_launches,
        "sharded_launches": sharded["cost_mapping"],
        "production_launches": prod_launches["cost_mapping"],
        "trajectory_launches": traj_launches["cost_mapping"],
        "max_abs_err": max(c["max_abs_err"] for c in cost.values()),
        "ms": bf16["ms_cold"], "ms_cold": bf16["ms_cold"],
        "ms_warm": bf16["ms_warm"], "plain_ms": bf16["plain_ms"],
        "bound_ms": bf16["bound_ms"], "bound_by": "bytes",
        "bytes_unpacked_ms": bf16["bytes_unpacked_ms"],
        "library_ms": None, "wrapper_ms": bf16["wrapper_ms"],
        "cold_floor_ms": bf16["floor_ms"], "pack_ms": bf16["pack_ms"],
        "ms_cold_float32_volumes": cost["float32"]["ms_cold"],
        "ms_warm_float32_volumes": cost["float32"]["ms_warm"],
        "bound_ms_float32_volumes": cost["float32"]["bound_ms"],
        "scene_launches": by_scenes("cost_mapping_scenes"),
        "lockstep_launches": lockstep_cost,
        "scenes_ms_cold": axis["cost_mapping_bfloat16"]["ms_cold"],
        "scenes_ms_warm": axis["cost_mapping_bfloat16"]["ms_warm"],
        "scenes_singles_ms_cold":
            axis["cost_mapping_bfloat16"]["singles_ms_cold"],
        "scenes_singles_ms_warm":
            axis["cost_mapping_bfloat16"]["singles_ms_warm"],
        "scenes_bound_ms": axis["cost_mapping_bfloat16"]["bound_ms"],
        "shape": [COST_RAYS, COST_SAMPLES, 3, *BENCH_VOLUMES]})
    kernels.append({
        "name": "geo_consistency", "route": "cuda",
        "source": "s_volsdf_tpu_torch/csrc/fusion.cu",
        "replaces": "s_volsdf_tpu/native/fusion.cpp:59",
        "launches": geo_launches,
        "sharded_launches": sharded["geo_consistency"],
        "production_launches": prod_launches["geo_consistency"],
        "max_abs_err": fusion["max_abs_err"], "ms": fusion["ms"],
        "plain_ms": fusion["plain_ms"], "bound_ms": fusion["bound_ms"],
        "bound_by": fusion["bound_by"], "library_ms": None,
        "bytes_ms": fusion["bytes_ms"], "ops_ms": fusion["ops_ms"],
        "fp64_instructions": fusion["fp64_instructions"],
        "sm_clock_mhz": fusion["sm_clock_mhz"],
        "wrapper_ms": fusion["wrapper_ms"], "shape": list(CASCADE_MVS_RES)})
    kernels.append({
        "name": "deform_conv", "route": "cuda",
        "source": "s_volsdf_tpu_torch/csrc/deform_conv.cu",
        "replaces": "s_volsdf_tpu/ops/deform_conv.py:29",
        "launches": dcn_launches, "sharded_launches": sharded["deform_conv"],
        "production_launches": prod_launches["deform_conv"],
        "max_abs_err": dcn["max_abs_err"],
        "ms": dcn["ms"], "plain_ms": dcn["plain_ms"],
        "bound_ms": dcn["bound_ms"], "bound_by": dcn["bound_by"],
        "library_ms": None, "tensor_ms": dcn["tensor_ms"],
        "blend_ms": dcn["blend_ms"], "bytes_ms": dcn["bytes_ms"],
        "fp32_bound_ms": dcn["fp32_bound_ms"],
        "ms_zero_offsets": dcn["ms_zero_offsets"],
        "outside_window_share": dcn["outside_window_share"],
        "sm_clock_mhz": dcn["sm_clock_mhz"],
        "shape": [DCN_CIN, *CASCADE_MVS_RES, DCN_CIN]})
    print(f"[env] chip_smoke.py in {time.perf_counter() - start:.2f} s "
          f"[{card}]", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
