"""The port's multi-device paths on several cards of one node (NCCL, one
rank a card), against one process:

    python3 -m s_volsdf_tpu_torch.tools.time_multi_card --ranks 1 2 4
        [--precision defaults float32] [--cli 4]

Run from the repository's root (it imports `chip_smoke.py`).

For each N of `--ranks`, N spawned ranks (`parallel.mesh.run_local_ranks`,
rank r on cuda:r) each build chip_smoke's trainer at bench.py's shapes
(576x768 sphere scene, 512 rays a step, three 192x288x384 volumes) at
each `--precision`, check one sharded step's gradients and loss against
the one-process step's on the same 512 rays and jitter (on the first
rank; `chip_smoke.step_agreement`: the one-step bars of
tests/test_torch_train_step.py for the precision), then run 20
steps of the trainer's loop (the ray-sharded one for N > 1, the
single-process one for N = 1) and 5 more under torch.profiler. One JSON
line per (N, precision): the median step (ms), training rays/s (512 /
median), device ms, busy share and launches a step, the flat gradient
all-reduce's us and bytes (N > 1), and whether every rank's parameters
are bit-equal after the steps. The global batch stays 512 rays, so N
ranks render 512 / N each.

`--cli N` then runs the command line under torchrun on N cards
(`python -m torch.distributed.run --nproc_per_node=N -m
s_volsdf_tpu_torch.cli.run`) on chip_smoke's 64x96 DTU fixture, 30
float32 steps, and the same command line in one process, and prints a
JSON line: both runs' seconds, every depth PFM's share of pixels within
1e-3 of the one-process run's (chip_smoke's phase 13 bar, 99.5%), and
the fused clouds' point counts. Prints the card's name and power limit
first.
"""

from __future__ import annotations

import argparse
import glob
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from s_volsdf_tpu_torch.engine.trainer import make_scan_train_fn
from s_volsdf_tpu_torch.parallel import mesh as pmesh
from s_volsdf_tpu_torch.parallel.train_parallel import (
    make_sharded_scan_train_fn)

STEPS = 20
PROFILE_STEPS = 5
CLI_STEPS = 30
DEPTH_TOL, DEPTH_SHARE = 1e-3, 0.995


def _rank(precision: str) -> dict:
    """One rank's run at bench.py's shapes (module docstring)."""
    import chip_smoke as cs
    dev = pmesh.rank_device()
    group = pmesh.node_group()
    cfg = cs.float32_dtu_config() if precision == "float32" \
        else cs.dtu_config()
    res = (cfg.max_h, cfg.max_w)
    t, mvs, scene, agree = cs.sharded_step_agreement(cfg, dev, group)
    out = {"rank": group.index, "agree": agree}
    kw = dict(use_mvs=True, n_views=3, img_res=res)
    run = (make_sharded_scan_train_fn(cfg, t.tx, group, **kw)
           if group.size > 1 else make_scan_train_fn(cfg, t.tx, **kw))
    t.state, losses, seconds = run(t.state, STEPS, scene, mvs, t.gen)
    prof = cs._profile_run(run, t.state, PROFILE_STEPS, scene, mvs, t.gen)
    out.update(
        median_ms=1e3 * float(np.median(seconds)),
        losses_finite=bool(np.all(np.isfinite([float(x.loss)
                                                for x in losses]))),
        params_sha=hashlib.sha256(cs._params_bytes(t.state.params))
        .hexdigest(), **prof)
    if group.size > 1:
        out["allreduce"] = cs._allreduce_us(group, t.state.params)
    return out


def time_ranks(n: int, precision: str) -> dict:
    rs = pmesh.run_local_ranks(_rank, n, precision, device="cuda",
                               timeout=900)
    r0 = rs[0]
    line = {"ranks": n, "precision": precision,
            "median_ms": r0["median_ms"],
            "rays_per_s": 512 / (r0["median_ms"] / 1e3),
            "rank_medians_ms": [r["median_ms"] for r in rs],
            "device_ms": r0["device_ms"], "busy": r0["busy"],
            "launches": r0["launches"], "agree": r0["agree"],
            "losses_finite": all(r["losses_finite"] for r in rs),
            "replicas_equal": len({r["params_sha"] for r in rs}) == 1}
    if n > 1:
        line["allreduce_us"] = r0["allreduce"]["us"]
        line["allreduce_bytes"] = r0["allreduce"]["bytes"]
    return line


def command_lines(n: int) -> dict:
    """The command line under torchrun on n cards and in one process."""
    import chip_smoke as cs
    from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
    from s_volsdf_tpu_torch.data.io import load_ply, read_pfm
    with tempfile.TemporaryDirectory() as tmp:
        make_dtu_fixture(os.path.join(tmp, "small"), scan_id=106,
                         img_res=cs.SMALL_RES)
        out = {}
        for run, launcher in (
                ("torchrun", [sys.executable, "-m", "torch.distributed.run",
                              "--standalone", f"--nproc_per_node={n}"]),
                ("one", [sys.executable])):
            root = os.path.join(tmp, run)
            argv = cs.small_run_args(tmp, os.path.join(root, "out")) + [
                f"exps_folder={os.path.join(root, 'exps')}",
                f"opt_stepNs=[{CLI_STEPS},0,0]",
                "train.train_compute_dtype=float32",
                "train.train_activation_dtype=float32",
                "train.mvs_pack_dtype=float32", "mvs.compute_dtype=float32"]
            t0 = time.perf_counter()
            subprocess.run(launcher + ["-m", "s_volsdf_tpu_torch.cli.run"]
                           + argv, check=True, timeout=900)
            out[f"{run}_s"] = time.perf_counter() - t0
            ply = os.path.join(root, "out", "mvsnet106_l3.ply")
            out[f"{run}_points"] = int(load_ply(ply)[0].shape[0])
        shares = []
        for path in sorted(glob.glob(os.path.join(tmp, "one", "out", "scan106",
                                                  "depth_est", "*.pfm"))):
            mine = path.replace(os.path.join(tmp, "one"),
                                os.path.join(tmp, "torchrun"))
            a, b = read_pfm(mine)[0], read_pfm(path)[0]
            shares.append(float(np.isclose(a, b, rtol=DEPTH_TOL,
                                           atol=DEPTH_TOL).mean())
                          if np.isfinite(a).all() else 0.0)
        out.update(ranks=n, depth_shares=shares,
                   depth_ok=len(shares) == 3 and min(shares) >= DEPTH_SHARE)
        return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    p.add_argument("--precision", nargs="+", default=["defaults", "float32"],
                   choices=["defaults", "float32"])
    p.add_argument("--cli", type=int, default=0,
                   help="cards for the command line under torchrun (0: none)")
    opt = p.parse_args(argv)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    ok = True
    for precision in opt.precision:
        for n in opt.ranks:
            line = time_ranks(n, precision)
            ok &= (line["losses_finite"] and line["replicas_equal"]
                   and line["agree"]["ok"])
            print(json.dumps(line), flush=True)
    if opt.cli:
        line = command_lines(opt.cli)
        ok &= line["depth_ok"]
        print(json.dumps(line), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
