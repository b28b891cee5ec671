"""DTU Chamfer evaluation of fused point clouds or meshes (counterpart
of s_volsdf_tpu/cli/eval_dtu.py:13-64).

    python -m s_volsdf_tpu_torch.cli.eval_dtu --datadir exps_mvs --scan 106 \
        --dataset_dir <official DTU dir with ObsMask/ and Points/stl/>

`--mode mesh` reads <datadir>/mvsnet{scan:03d}_l3.ply as a triangle mesh
and samples its surface first (`eval_geo.mesh_to_pcd`).
"""

from __future__ import annotations

import argparse
import os
from typing import List, Optional

import numpy as np

from s_volsdf_tpu_torch.engine.eval_geo import eval_dtu_scan

DTU_SCANS = [21, 24, 34, 37, 38, 40, 82, 106, 110, 114, 118]


def main(argv: Optional[List[str]] = None) -> List[List[float]]:
    """Prints acc, comp and overall (mm) per scan and their mean; returns
    the per-scan rows."""
    p = argparse.ArgumentParser()
    p.add_argument("--datadir", type=str, required=True,
                   help="dir with mvsnetXXX_l3.ply predictions")
    p.add_argument("--data_dir_root", type=str, default="data_s_volsdf",
                   help="GT data root; the official DTU dir is derived "
                        "as <root>/DTU/DTU_MVS_Data")
    p.add_argument("--dataset_dir", type=str, default="",
                   help="official DTU dir (ObsMask/, Points/stl/); "
                        "overrides --data_dir_root derivation")
    p.add_argument("--scan", type=int, default=-1)
    p.add_argument("--max_dist", type=float, default=20.0)
    p.add_argument("--downsample_density", "--downsample", type=float,
                   default=0.2)
    p.add_argument("--patch_size", type=float, default=60.0,
                   help="bbox crop margin (official protocol)")
    p.add_argument("--mode", default="pcd", choices=["pcd", "mesh"],
                   help="'mesh' samples a predicted mesh PLY first")
    p.add_argument("--visualize_threshold", type=float, default=10.0)
    p.add_argument("-ve", "--visualize_error", action="store_true",
                   help="write error-colored clouds to <datadir>/result")
    args = p.parse_args(argv)

    dataset_dir = args.dataset_dir or os.path.join(
        args.data_dir_root, "DTU", "DTU_MVS_Data")
    scans = DTU_SCANS if args.scan < 0 else [args.scan]
    results = []
    print("scan, acc, comp, overall (mm)")
    for scan in scans:
        ply = os.path.join(args.datadir, f"mvsnet{scan:03d}_l3.ply")
        if not os.path.exists(ply):
            print(f"scan{scan:03d} MISSING {ply}")
            continue
        r = eval_dtu_scan(ply, scan, dataset_dir, mode=args.mode,
                          max_dist=args.max_dist,
                          downsample=args.downsample_density,
                          patch_size=args.patch_size,
                          visualize_error=args.visualize_error,
                          visualize_threshold=args.visualize_threshold,
                          vis_dir=os.path.join(args.datadir, "result"))
        print(f"scan{scan:03d} {r['acc']:.2f} {r['comp']:.2f} "
              f"{r['overall']:.2f}")
        results.append([r["acc"], r["comp"], r["overall"]])
    if results:
        m = np.mean(results, axis=0)
        print(f"mean_err {m[0]:.3f} {m[1]:.3f} {m[2]:.3f}")
    return results


if __name__ == "__main__":
    main()
