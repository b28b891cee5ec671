"""Times chip_smoke's BlendedMVS scene on one GPU with PNG images against
the same scene with JPEG images, in turns in one process.

    python3 -m s_volsdf_tpu_torch.tools.time_bmvs_scene [--pairs N]

Run from the repository's root (it imports `chip_smoke.py`). It writes
the 576x768 BMVS fixture (scan1) twice, once with PNG images and once
with JPEG images (quality 95, 4:2:0), builds one cascade engine at He's
gain, and runs `save_scene_depth` at chip_smoke's phase-11(c) shapes
(x2 MVS resolution, D = 192/32/8, 20 background steps at the defaults)
once on the PNG scene to warm up, then png, jpg, jpg, png, ... for N
pairs. Each turn prints one JSON line: the scene's seconds, its stage,
feedback-render and output seconds, the trainer's median and summed
step seconds, what is left of the scene's seconds beside them, and the
host seconds to read every image of that fixture through
`data.io.read_image`. The card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def read_all_seconds(data_root: str, scan: str) -> float:
    from s_volsdf_tpu_torch.data.io import read_image
    image_dir = os.path.join(data_root, "BlendedMVS", scan, "image")
    t0 = time.perf_counter()
    for name in sorted(os.listdir(image_dir)):
        read_image(os.path.join(image_dir, name))
    return time.perf_counter() - t0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--pairs", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    import numpy as np
    import torch
    import chip_smoke
    from s_volsdf_tpu_torch.data.fixtures import make_bmvs_fixture
    from s_volsdf_tpu_torch.engine.runner import MVSEngine, save_scene_depth
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda")
    scan = chip_smoke.BMVS_SCAN
    with tempfile.TemporaryDirectory() as tmp:
        cfgs = {}
        for fmt in ("png", "jpg"):
            root = os.path.join(tmp, fmt)
            make_bmvs_fixture(root, img_res=chip_smoke.CASCADE_RES,
                              image_format=fmt)
            cfgs[fmt] = chip_smoke.bmvs_scene_config(root)
        engine = MVSEngine(cfgs["png"], device=dev)
        chip_smoke.he_gain(engine.net)
        turns = ["png"] + ["png", "jpg", "jpg", "png"] * (args.pairs // 2) \
            + ["png", "jpg"] * (args.pairs % 2)
        for i, fmt in enumerate(turns):
            cfg = cfgs[fmt]
            t0 = time.perf_counter()
            res = save_scene_depth(cfg, scan, engine=engine,
                                   exps_root=os.path.join(tmp, f"exps{i}"))
            torch.cuda.synchronize()
            scene_s = time.perf_counter() - t0
            steps = res["trainer"].step_seconds
            parts = (sum(res["stage_seconds"]) + sum(res["feedback_seconds"])
                     + res["outputs_seconds"] + sum(steps))
            print(json.dumps({
                "turn": i, "warm_up": i == 0, "images": fmt,
                "scene_s": scene_s, "stage_s": res["stage_seconds"],
                "feedback_s": res["feedback_seconds"],
                "outputs_s": res["outputs_seconds"],
                "step_median_ms": 1e3 * float(np.median(steps)),
                "steps_s": float(sum(steps)), "rest_s": scene_s - parts,
                "read_all_images_s": read_all_seconds(cfg.data_dir_root,
                                                      scan),
                "card": card}), flush=True)


if __name__ == "__main__":
    main()
