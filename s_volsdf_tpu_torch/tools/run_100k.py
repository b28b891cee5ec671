"""The published production schedule, opt_stepNs=[100000,0,0], at
production shapes, with a hard kill and its resume (counterpart of
tools/run_100k.py, on the port).

    python -m s_volsdf_tpu_torch.tools.run_100k --exps /tmp/run100k \\
        --target 100000 --crash-at 52000     # exits 17 after step 52000
    python -m s_volsdf_tpu_torch.tools.run_100k --exps /tmp/run100k \\
        --target 100000 --resume             # is_continue -> 100000

    python -m s_volsdf_tpu_torch.tools.run_100k --preset bmvs \\
        --target 10000 --exps /tmp/bmvs      # the NeRF++ background model

It builds a 576x768 synthetic fixture under <exps>/data on the first
run (DTU scan106 with 7 distinct held-out views, for
`tools.run_flagship`; or BlendedMVS scan1), makes stage 0's probability
volumes (`--prior gt`: Gaussian bumps around the analytic sphere's
depth with noise, `np.random.default_rng(7)`, standing in for a
pretrained cascade; `--prior cascade`: the cascade's random weights),
and trains the VolSDF field in chunks of `--chunk` steps through the
trainer's own loop (`VolTrainer._get_loop`). After each chunk it
appends a row to the JSONL log (<exps>/run100k.jsonl or `--log`): the
last step's losses, PSNR and beta, the chunk's mean MVS loss, the NaN
guard's skipped steps so far, the chunk's seconds and the wall clock. A
checkpoint is written when step % (chunk * 40) < chunk. With
`--crash-at N` the process exits with code 17 (`os._exit`, no kill-site
checkpoint unless `--crash-save`) once the step passes N, so `--resume`
restarts from the last periodic checkpoint and replays the steps after
it: the checkpoint carries the pixel and sampler generator, and the
replayed rows equal the killed run's. At the end it renders the
feedback depth of each training view and scores it against the sphere
(`data.synthetic.sphere_radial_error`, mm), in a last record
{"done": true, ...}.

The rows and the last record have the JAX tool's keys; the last record
and each process's first row also carry "card", the card's name and
power limit (`utils.device.card_name`), so every chunk_s is tied to the
card it was timed on. `tools.summarize_100k` turns the log into a
markdown run log.

`main(argv, img_res=..., overrides=..., device=...)` runs it with a
fixture of another size and further config overrides (the CPU tests: a
48x64 scene, narrow widths, device "cpu"); the command line runs the
production shapes on "cuda".
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

PRODUCTION_RES = (576, 768)
N_EVAL_VIEWS = 7        # distinct held-out views, scored by run_flagship
LOG_EVERY = 5000        # steps between rows also printed


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exps", default="/tmp/run100k")
    ap.add_argument("--target", type=int, default=100000)
    ap.add_argument("--crash-at", type=int, default=0,
                    help="os._exit(17) once the step passes this; no "
                         "checkpoint is written at the kill site, so the "
                         "resume recovers from the last periodic one")
    ap.add_argument("--crash-save", action="store_true",
                    help="also checkpoint right before the simulated kill")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--chunk", type=int, default=250)
    ap.add_argument("--log", default=None)
    ap.add_argument("--preset", default="dtu", choices=["dtu", "bmvs"])
    ap.add_argument("--prior", default="gt", choices=["gt", "cascade"],
                    help="stage 0's volumes: 'gt' = Gaussian bumps around "
                         "the fixture's analytic depth with noise (a "
                         "pretrained cascade's stand-in: the GCE gate "
                         "trains open); 'cascade' = the cascade's random "
                         "weights")
    ap.add_argument("--prior-noise", type=float, default=2.5,
                    help="metric std of the per-pixel depth jitter of "
                         "--prior gt (about one DTU depth interval)")
    ap.add_argument("--prior-sigma", type=float, default=1.5,
                    help="--prior gt bump width in hypothesis intervals "
                         "(1.5 peaks near 0.24; about 1.0 with "
                         "--prior-floor 0.02 is a trained cascade's)")
    ap.add_argument("--prior-floor", type=float, default=0.05,
                    help="--prior gt uniform background mass")
    ap.add_argument("--gate-rescue", action="store_true",
                    help="loss.gate_rescue=true: the depth-anchor term "
                         "for the anneal-boundary GCE collapse")
    ap.add_argument("--gate-rescue-weight", type=float, default=0.1)
    ap.add_argument("--no-mvs", action="store_true",
                    help="train without the MVS regulariser (the control "
                         "arm)")
    ap.add_argument("--seed", type=int, default=None,
                    help="override cfg.seed (parameter init and the "
                         "pixel/sampler generator); runs record it")
    return ap


def scene_setup(preset: str, root: str, img_res: Tuple[int, int],
                resume: bool) -> Tuple[str, List[str]]:
    """(scene name, config overrides) of the run's fixture under root,
    writing the fixture when it is not there yet."""
    from s_volsdf_tpu_torch.data.fixtures import (make_bmvs_fixture,
                                                  make_dtu_fixture)
    H, W = img_res
    common = [f"data_dir_root={root}", f"dataset.data_dir_root={root}",
              f"dataset.img_res=[{H},{W}]", f"max_h={H}", f"max_w={W}",
              f"is_continue={'true' if resume else 'false'}"]
    if preset == "bmvs":
        if not os.path.exists(os.path.join(root, "BlendedMVS")):
            print(f"building the BMVS fixture ({H}x{W})...", flush=True)
            make_bmvs_fixture(root, scan_id=1, img_res=img_res)
        return "scan1", common + ["mvs.interval_scale=1.0"]
    if not os.path.exists(os.path.join(root, "DTU")):
        print(f"building the DTU fixture ({H}x{W})...", flush=True)
        make_dtu_fixture(root, scan_id=106, img_res=img_res,
                         n_eval_views=N_EVAL_VIEWS)
    return "scan106", common + ["mvs.numdepth=192"]


def gt_prior(cfg, trainer, samples, args) -> List[Dict]:
    """Stage 0's outputs from the analytic sphere (`gt_prob_volume` at
    each training view's quarter MVS resolution), on the trainer's
    device."""
    from s_volsdf_tpu_torch.data.synthetic import gt_prob_volume
    rng = np.random.default_rng(7)
    outs = []
    for i, tid in enumerate(trainer.trains_i):
        s = samples[i]
        if s.view_ids[0] != tid:
            raise ValueError(f"sample {i} is view {s.view_ids[0]}, not {tid}")
        Hc, Wc = s.imgs.shape[1] // 4, s.imgs.shape[2] // 4
        K = trainer.scene.intrinsics[tid].copy()
        K[0, :] *= Wc / trainer.scene.img_res[1]
        K[1, :] *= Hc / trainer.scene.img_res[0]
        prob, hyp = gt_prob_volume(
            trainer.scene.poses[tid], K, (Hc, Wc), s.depth_values,
            trainer.scale_factor, sigma_intervals=args.prior_sigma,
            floor=args.prior_floor, inverse_depth=bool(cfg.inverse_depth),
            depth_noise=args.prior_noise, rng=rng)
        dvals = np.broadcast_to(hyp[:, None, None], prob.shape)
        outs.append({k: torch.as_tensor(np.ascontiguousarray(a),
                                        device=trainer.device)
                     for k, a in (("prob_volume", prob),
                                  ("depth_values", dvals))})
    return outs


def chunk_row(losses, n: int, step: int, beta: float, guard_trips: int,
              chunk_s: float, wall: float, phase: str,
              gate_rescue: bool) -> Dict:
    """One chunk's JSONL row (the JAX tool's keys): the last step's
    losses, the chunk's mean MVS loss (and rescue loss)."""
    last = losses[-1]
    rec = {
        "step": step,
        "n": int(n),
        "loss": round(last.loss, 5),
        "rgb": round(last.rgb_loss, 5),
        "eik": round(last.eikonal_loss, 5),
        "mvs": round(last.mvs_loss, 5),
        # the chunk's mean: whether the GCE gate is open is a per-ray
        # question, not the last step's
        "mvs_mean": round(float(np.mean([lo.mvs_loss for lo in losses])), 6),
        "sparse": round(last.sparse_loss, 5),
        **({"rescue_mean": round(float(np.mean(
            [lo.rescue_loss for lo in losses])), 6)} if gate_rescue else {}),
        "psnr": round(last.psnr, 3),
        "beta": round(beta, 6),
        "guard_trips": guard_trips,
        "chunk_s": round(chunk_s, 3),
        "wall": round(wall, 1),
        "phase": phase,
    }
    return rec


def run(args, *, img_res: Tuple[int, int] = PRODUCTION_RES,
        overrides: Sequence[str] = (), device=None) -> Dict:
    """The schedule of `args` (build_parser's); returns {"done": the last
    record, "depths": {view: its feedback depth}} (a kill exits)."""
    from s_volsdf_tpu_torch.config import load_config, per_scene_overrides
    from s_volsdf_tpu_torch.data.synthetic import sphere_radial_error
    from s_volsdf_tpu_torch.engine.runner import (MVSEngine, run_mvs_stage,
                                                  setup_scene)
    from s_volsdf_tpu_torch.engine.train_step import pack_for_chunk
    from s_volsdf_tpu_torch.engine.trainer import _host_losses
    from s_volsdf_tpu_torch.utils.device import card_name, resolve_device

    dev = resolve_device(device, "run_100k")
    card = card_name(dev)
    os.makedirs(args.exps, exist_ok=True)
    log_path = args.log or os.path.join(args.exps, "run100k.jsonl")
    scene_name, ovs = scene_setup(args.preset,
                                  os.path.join(args.exps, "data"),
                                  tuple(img_res), args.resume)
    if args.seed is not None:
        ovs.append(f"seed={args.seed}")
    if args.gate_rescue:
        ovs += ["loss.gate_rescue=true",
                f"loss.gate_rescue_weight={args.gate_rescue_weight}"]
    cfg = load_config(args.preset, overrides=ovs + list(overrides))
    cfg = per_scene_overrides(cfg, scene_name)

    t_all = time.time()
    print(f"[{time.strftime('%H:%M:%S')}] setup_scene...", flush=True)
    sc = setup_scene(cfg, scene_name, exps_root=args.exps, device=dev)
    print(f"[{time.strftime('%H:%M:%S')}] setup done "
          f"({time.time() - t_all:.0f}s)", flush=True)
    trainer = sc["trainer"]
    trainer.chunk_steps = args.chunk
    print(f"trainer at step {trainer.state.iter_step} "
          f"(resume={args.resume})", flush=True)

    t0 = time.time()
    if args.prior == "cascade":
        outs, _ = run_mvs_stage(cfg, MVSEngine(cfg, device=dev), sc, 0)
    else:
        outs = gt_prior(cfg, trainer, sc["samples"], args)
    trainer.stg = 0
    mvs = trainer.get_mvs_input(outs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_cascade = time.time() - t0
    print(f"stage-0 volumes ({args.prior}): {t_cascade:.1f}s", flush=True)

    use_mvs = not args.no_mvs
    run_chunk = trainer._get_loop(use_mvs)
    scene_dev = trainer.scene_tensors()
    mvs_dev = pack_for_chunk(cfg, mvs) if use_mvs else None

    guard_trips = 0
    phase = "resume" if args.resume else "initial"
    first_chunk = True
    with open(log_path, "a") as logf:
        while trainer.state.iter_step < args.target:
            n = min(args.chunk, args.target - trainer.state.iter_step)
            t0 = time.time()
            trainer.state, losses, _ = run_chunk(
                trainer.state, n, scene_dev, mvs_dev, trainer.gen)
            losses = [_host_losses(lo) for lo in losses]
            dt = time.time() - t0
            step = trainer.state.iter_step
            guard_trips += sum(lo.grad_finite == 0.0 for lo in losses)
            beta = abs(float(trainer.state.params.density.beta.detach()))
            rec = chunk_row(losses, n, step, beta, guard_trips, dt,
                            time.time() - t_all, phase, args.gate_rescue)
            if first_chunk:
                print(f"first chunk {dt:.1f}s", flush=True)
                rec["card"] = card
                first_chunk = False
            logf.write(json.dumps(rec) + "\n")
            logf.flush()
            if step % LOG_EVERY < args.chunk:
                print(json.dumps(rec), flush=True)
            if step % (args.chunk * 40) < args.chunk:
                trainer.save_checkpoint()
            if args.crash_at and step >= args.crash_at:
                if args.crash_save:
                    trainer.save_checkpoint()
                print(f"simulating hard kill at step {step} "
                      f"(kill-site checkpoint: {args.crash_save})",
                      flush=True)
                logf.close()
                os._exit(17)

        trainer.save_checkpoint()
        trainer.save_checkpoint("epoch_final")

        # The feedback renders (what the pipeline feeds the next stage)
        # scored against the analytic sphere, every training view.
        t0 = time.time()
        radial, depths = {}, {}
        for v in trainer.trains_i:
            d = trainer.render_mvs(v)
            depths[int(v)] = d
            mean_e, med_e, n_px = sphere_radial_error(
                trainer.scene.poses[v], trainer.scene.intrinsics[v],
                trainer.scene.img_res, d, trainer.scale_factor)
            radial[int(v)] = {"mean_mm": round(mean_e, 3),
                              "median_mm": round(med_e, 3), "n_px": n_px}
        t_render = time.time() - t0
        depth = depths[int(trainer.trains_i[0])]
        rec = {
            "done": True, "steps": trainer.state.iter_step,
            "use_mvs": use_mvs, "prior": args.prior,
            "guard_trips": guard_trips,
            "cascade_s": round(t_cascade, 1),
            "feedback_render_s": round(t_render, 1),
            "total_wall_s": round(time.time() - t_all, 1),
            "depth_range": [float(depth.min()), float(depth.max())],
            "radial_error": radial,
            "card": card,
        }
        logf.write(json.dumps(rec) + "\n")
    print(json.dumps(rec), flush=True)
    return {"done": rec, "depths": depths}


def main(argv: Optional[List[str]] = None, **kw) -> Dict:
    return run(build_parser().parse_args(argv), **kw)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
