"""Times the CasMVSNet cascade of this checkout on one GPU at each
`mvs.compute_dtype`, against another checkout's float32 cascade, in
turns.

    python3 -m s_volsdf_tpu_torch.tools.time_cascade --other DIR [--pairs N]

DIR is another checkout of the repository (for the parent commit:
`git archive HEAD | tar -x -C DIR`). Each turn is a process started in
one checkout's root, which imports that checkout's `chip_smoke.py`,
writes its 576x768 DTU-layout fixture and runs `save_scene_depth` on it
at chip_smoke's phase-6 shapes (x2 MVS resolution 1152x1536, D =
192/32/8, full casmvsnet widths, random weights from seed 0) with no
VolSDF budget (opt_stepNs 0, 0, 0: the three stages over the three
reference views and the outputs), twice; it prints the second run's
seconds and peak allocated memory per stage. This checkout runs
"float32" and "defaults" (bf16 convs); the other runs "float32" only.
No TF32 flag is set: each checkout's engine runs as its users get it
(a port that does not keep its float32 convs out of TF32 runs them in
TF32, cuDNN's default). The turns go other, this, this, other, ... for
N pairs. Prints the card's name and power limit first, one JSON line
per turn.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def child(tree: str, precision: str) -> None:
    sys.path.insert(0, tree)
    import torch
    import chip_smoke
    from s_volsdf_tpu_torch.engine.runner import MVSEngine, save_scene_depth
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as tmp:
        data_root = os.path.join(tmp, "data")
        chip_smoke.make_dtu_fixture(data_root, img_res=chip_smoke.CASCADE_RES)
        args = (data_root, chip_smoke.CASCADE_RES, chip_smoke.CASCADE_NDEPTHS,
                chip_smoke.CASCADE_X2, (0, 0, 0))
        if precision == "float32":
            cfg = chip_smoke.cascade_config(*args)
        else:
            cfg = chip_smoke.cascade_config(*args, base=chip_smoke.dtu_config)
        engine = MVSEngine(cfg, device=dev)
        for run in range(2):
            res = save_scene_depth(cfg, chip_smoke.SCAN,
                                   exps_root=os.path.join(tmp, str(run)),
                                   engine=engine)
            torch.cuda.synchronize()
    print(json.dumps({
        "tree": tree, "precision": precision,
        "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
        "stage_seconds": res["stage_seconds"],
        "stage_peak_gib": [b / 2 ** 30 for b in res["stage_peak_bytes"]]}))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--precision", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child, args.precision)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    other = os.path.abspath(args.other)
    trees = [other, REPO, REPO, other] * (args.pairs // 2) \
        + [other, REPO] * (args.pairs % 2)
    for tree in trees:
        for precision in (("float32",) if tree == other
                          else ("float32", "defaults")):
            res = subprocess.run(
                [sys.executable, os.path.abspath(__file__), "--other", other,
                 "--child", tree, "--precision", precision], cwd=tree,
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError(f"turn {tree} {precision} failed:\n"
                                   f"{res.stderr[-4000:]}")
            line = json.loads(res.stdout.strip().splitlines()[-1])
            line["card"] = card
            print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
