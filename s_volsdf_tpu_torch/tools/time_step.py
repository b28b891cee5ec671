"""Times the training step of this checkout on one GPU against another
checkout's, in turns, to tell a change to the step from the host's noise.

    python3 -m s_volsdf_tpu_torch.tools.time_step --other DIR [--pairs N]
        [--precision float32 defaults] [--profile]

DIR is another checkout of the repository (for the parent commit:
`git archive HEAD | tar -x -C DIR`). Each turn is a process started in
one checkout's root, which imports that checkout's `chip_smoke.py` (so
its imports are the smoke script's) and runs its phase 4: `make_trainer`
at bench.py's shapes (576x768 scene, 512 rays a step, three 192x288x384
MVS volumes) and 20 steps, one step per chunk, at each `--precision`:
"float32" (`chip_smoke.float32_dtu_config`) and "defaults" (the dtu
preset as it is: the JAX package's bf16 training precision; a checkout
whose port refuses it skips it). It prints the median step time. With
`--profile`, 5 more steps run under torch.profiler: the device time per
step (the union of the kernels' intervals), the device-busy share (that
time over the median unprofiled step) and the kernels (and copies)
launched per step. The turns go other, this, this, other, ... for N
pairs. Prints the card's name and power limit first, one JSON line per
turn, then each checkout's medians.

    python3 -m s_volsdf_tpu_torch.tools.time_step --scenes 1 2 4
        [--precision float32 defaults] [--profile] [--row-split 16 1]

times the lockstep multi-scene step of this checkout instead
(`engine.multiscene.run_joint`, S scenes in one step), in one process:
`chip_smoke.py`'s phase 13 scenes (576x768 spheres of per-scene radius,
bench.py's volumes, 512 rays a scene), first each scene's serial
trainer for 20 steps, then for each S 20 lockstep steps of the first S
scenes: the median step, training rays/s (S x 512 / median), the peak
memory, and S serial steps' total beside them; with `--profile` 5 more
lockstep steps under torch.profiler (device ms, busy share, launches a
step). One JSON line per precision and S. `--row-split` times each
S at each value of `models.layers.ROW_SPLIT` in turn (the row blocks of
a stacked product on the card; 1 runs S products as they are).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 20
PROFILE_STEPS = 5


def _device_time(prof) -> tuple:
    """(seconds the device was busy, kernels and copies launched) in a
    torch.profiler run: the union of its device events' intervals."""
    from torch.autograd import DeviceType
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy * 1e-6, len(spans)


def child(tree: str, precision: str, profile: bool) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke
    from s_volsdf_tpu_torch import config
    if precision == "defaults" and not hasattr(config, "check_ported"):
        print(json.dumps({"tree": tree, "precision": precision,
                          "skipped": "this port refuses the bf16 defaults"}))
        return
    dev = torch.device("cuda")
    cfg = (chip_smoke.float32_dtu_config() if precision == "float32"
           else config.dtu_config())
    trainer = chip_smoke.make_trainer(cfg, (cfg.max_h, cfg.max_w),
                                      (192, 288, 384), dev)
    trainer.run(STEPS)
    torch.cuda.synchronize()
    out = {"tree": tree, "precision": precision,
           "median_ms": 1e3 * float(np.median(trainer.chunk_seconds))}
    if profile:
        from torch.profiler import ProfilerActivity
        with torch.profiler.profile(activities=[ProfilerActivity.CPU,
                                                ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.run(PROFILE_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        busy, launches = _device_time(prof)
        out.update({
            "device_ms_per_step": 1e3 * busy / PROFILE_STEPS,
            "busy_share": busy / PROFILE_STEPS / (out["median_ms"] * 1e-3),
            "launches_per_step": launches / PROFILE_STEPS,
            "profiled_ms_per_step": 1e3 * wall / PROFILE_STEPS})
    print(json.dumps(out))


def scenes(sizes, precisions, profile: bool, row_splits) -> None:
    """The lockstep step at each S of `sizes` (see the module
    docstring)."""
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import chip_smoke
    from s_volsdf_tpu_torch import config
    from s_volsdf_tpu_torch.engine.multiscene import run_joint
    from s_volsdf_tpu_torch.models import layers
    dev = torch.device("cuda")
    data = chip_smoke.ms_scenes(dev, max(sizes))
    for precision in precisions:
        cfg = (chip_smoke.float32_dtu_config() if precision == "float32"
               else config.dtu_config())
        serial = chip_smoke.ms_trainers(cfg, data, dev)
        for t in serial:
            t.run(STEPS)
        serial_ms = [1e3 * float(np.median(t.chunk_seconds)) for t in serial]
        del serial
        for S, split in ((S, k) for S in sizes for k in row_splits):
            layers.ROW_SPLIT = split
            trainers = chip_smoke.ms_trainers(cfg, data[:S], dev)
            torch.cuda.reset_peak_memory_stats(dev)
            run_joint(trainers, STEPS, chunk_steps=STEPS)
            torch.cuda.synchronize()
            med = 1e3 * float(np.median(trainers[0].step_seconds))
            out = {"precision": precision, "scenes": S, "row_split": split,
                   "median_ms": med,
                   "rays_per_s": S * cfg.train.num_pixels / (med / 1e3),
                   "peak_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
                   "serial_ms": serial_ms[:S],
                   "serial_total_ms": sum(serial_ms[:S])}
            if profile:
                prof = chip_smoke._profile_joint(trainers, PROFILE_STEPS)
                out.update({"device_ms_per_step": prof["device_ms"],
                            "busy_share": prof["device_ms"] / med,
                            "launches_per_step": prof["launches"]})
            print(json.dumps(out), flush=True)
            del trainers
            torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout of the repository")
    ap.add_argument("--scenes", type=int, nargs="+",
                    help="time the lockstep step of this checkout at these "
                    "numbers of scenes instead")
    ap.add_argument("--row-split", type=int, nargs="+", default=None,
                    help="with --scenes: time each of these row splits of "
                    "the stacked products")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--precision", nargs="+", default=["float32"],
                    choices=["float32", "defaults"])
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.scenes:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, check=True).stdout.strip()
        print(f"[card] {card}", flush=True)
        from s_volsdf_tpu_torch.models import layers
        scenes(args.scenes, args.precision, args.profile,
               args.row_split or [layers.ROW_SPLIT])
        return
    if not args.other:
        ap.error("--other is required (or --scenes)")
    if args.child:
        for precision in args.precision:
            child(args.child, precision, args.profile)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    other = os.path.abspath(args.other)
    trees = [other, REPO, REPO, other] * (args.pairs // 2) \
        + [other, REPO] * (args.pairs % 2)
    runs = []
    for tree in trees:
        for precision in args.precision:
            cmd = [sys.executable, os.path.abspath(__file__), "--other",
                   other, "--child", tree, "--precision", precision]
            res = subprocess.run(cmd + (["--profile"] if args.profile else []),
                                 cwd=tree, capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"turn {tree} {precision} failed:\n"
                                   f"{res.stderr[-4000:]}")
            runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
            print(json.dumps(runs[-1]), flush=True)
    for tree in (other, REPO):
        for precision in args.precision:
            mine = [r for r in runs if r["tree"] == tree
                    and r["precision"] == precision and "median_ms" in r]
            if mine:
                print(f"[step] {tree} {precision}: median ms/step " + " / ".join(
                    f"{r['median_ms']:.2f}" for r in mine) + f" [{card}]",
                    flush=True)


if __name__ == "__main__":
    main()
