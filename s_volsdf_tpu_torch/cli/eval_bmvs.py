"""BlendedMVS Chamfer evaluation of fused point clouds (counterpart of
s_volsdf_tpu/cli/eval_bmvs.py). Host code: it needs no card.

    python -m s_volsdf_tpu_torch.cli.eval_bmvs --datadir exps_mvs --scan 1 \\
        --data_dir_root data_s_volsdf
    python -m s_volsdf_tpu_torch.cli.eval_bmvs --save_gt --scan 1 \\
        --dataset_dir bmvs/dataset_textured_meshes

The first form reads <datadir>/mvsnet{scan:03d}_l3.ply and the GT cloud
<data_dir_root>/BlendedMVS/stl/scan{n}_crop.ply (scan{n}.ply with
--no_crop) and prints each scan's Chamfer distance and their mean; the
second makes the GT clouds from the textured meshes (`save_bmvs_gt`).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from s_volsdf_tpu_torch.engine.eval_geo import eval_bmvs_scan, save_bmvs_gt


def main(argv: Optional[List[str]] = None) -> List[float]:
    """Returns the overall Chamfer distance of each scan evaluated (none
    with --save_gt)."""
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", type=str, default="")
    p.add_argument("--data_dir_root", type=str, default="data_s_volsdf")
    p.add_argument("--scan", type=int, default=-1)
    p.add_argument("--no_crop", action="store_true")
    p.add_argument("--save_gt", action="store_true",
                   help="make the GT clouds from textured meshes and exit")
    p.add_argument("--dataset_dir", type=str,
                   default="bmvs/dataset_textured_meshes",
                   help="textured-mesh root (with --save_gt)")
    p.add_argument("--sample", type=int, default=100000)
    p.add_argument("--crop_min_z", type=float, default=None,
                   help="with --save_gt: also write scan{n}_crop.ply "
                        "keeping points above this ground plane")
    p.add_argument("-ve", "--visualize_error", action="store_true",
                   help="write error-colored clouds to <datadir>/result")
    args = p.parse_args(argv)

    scans = list(range(1, 10)) if args.scan < 0 else [args.scan]
    if args.save_gt:
        for scan in scans:
            save_bmvs_gt(scan, args.dataset_dir, args.data_dir_root,
                         n_samples=args.sample, crop_min_z=args.crop_min_z)
        return []

    if not args.datadir:
        p.error("--datadir is required unless --save_gt")
    print("ply_name, chamfer(mm)")
    results = []
    for scan in scans:
        ply = os.path.join(args.datadir, f"mvsnet{scan:03d}_l3.ply")
        if not os.path.exists(ply):
            print(f"scan{scan} MISSING {ply}")
            continue
        r = eval_bmvs_scan(ply, scan, args.data_dir_root,
                           no_crop=args.no_crop,
                           visualize_error=args.visualize_error,
                           vis_dir=os.path.join(args.datadir, "result"))
        print(f"mvsnet{scan:03d}_l3.ply {r['overall']:.2f}")
        results.append(r["overall"])
    if results:
        print(f"mean {np.mean(results):.3f}")
    return results


if __name__ == "__main__":
    main()
