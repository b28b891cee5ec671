"""Times the training step of this checkout on one GPU against another
checkout's, in turns, to tell a change to the step from the host's noise.

    python3 -m s_volsdf_tpu_torch.tools.time_step --other DIR [--pairs N]

DIR is another checkout of the repository (for the parent commit:
`git archive HEAD | tar -x -C DIR`). Each turn is a process started in
one checkout's root, which imports that checkout's `chip_smoke.py` (so
its imports are the smoke script's) and runs its phase 4: `make_trainer`
at bench.py's shapes (576x768 scene, 512 rays a step, three 192x288x384
MVS volumes, float32) and 20 steps, one step per chunk; it prints the
median step time. The turns go other, this, this, other, ... for N
pairs. Prints the card's name and power limit first, one JSON line per
turn, then each checkout's medians.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
STEPS = 20


def child(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch
    import chip_smoke
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = chip_smoke.float32_dtu_config()
    trainer = chip_smoke.make_trainer(cfg, (cfg.max_h, cfg.max_w),
                                      (192, 288, 384), dev)
    trainer.run(STEPS)
    torch.cuda.synchronize()
    print(json.dumps({"tree": tree, "median_ms": 1e3 * float(
        np.median(trainer.chunk_seconds))}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
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
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--other", other, "--child", tree], cwd=tree,
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"turn {tree} failed:\n{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for tree in (other, REPO):
        ms = [r["median_ms"] for r in runs if r["tree"] == tree]
        print(f"[step] {tree}: median ms/step " + " / ".join(
            f"{m:.2f}" for m in ms) + f" [{card}]", flush=True)


if __name__ == "__main__":
    main()
