"""Novel-view and mesh evaluation command line (counterpart of
s_volsdf_tpu/cli/eval_vsdf.py), on "cuda" unless told otherwise:

    python -m s_volsdf_tpu_torch.cli.eval_vsdf --conf dtu --scan_ids 106 \\
        --eval_rendering --eval_mesh
    python -m s_volsdf_tpu_torch.cli.eval_vsdf --conf dtu --scan_ids 106 \\
        --eval_rendering --result_from default

For each scan: the newest run of <exps_folder>/<expname>_<id> holding the
checkpoint (or --timestamp's, or --ckpt_dir), then with --eval_mesh the
mesh <evals_folder>/<train.expname>_<id>/mesh/scan<id>.ply (in the DTU
box of <data_dir_root>/DTU/bbs.npz when it exists), and with
--eval_rendering the renders of the eval views into
rendering_<epoch>/ (--result_from None) or their PSNR, SSIM and LPIPS
(--result_from default|blend; LPIPS needs --lpips_weights, a checkpoint
directory of converted weights). The flags and defaults are the JAX
command line's; --gpu is accepted and ignored. Under torchrun
(`torchrun --nproc_per_node=N -m s_volsdf_tpu_torch.cli.eval_vsdf ...`)
the ranks share each render's rays and each grid's points
(parallel.eval_group) and the node's first rank writes the files.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
from typing import Dict, List, Optional

import numpy as np

from s_volsdf_tpu_torch.config import load_config
from s_volsdf_tpu_torch.data.scene_dataset import load_scene
from s_volsdf_tpu_torch.engine.eval_nvs import (eval_rendered_views,
                                                export_mesh, find_checkpoint,
                                                load_trained_params,
                                                render_eval_views)
from s_volsdf_tpu_torch.parallel.mesh import launched
from s_volsdf_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("s_volsdf_tpu_torch")

DTU_SCANS = [21, 24, 34, 37, 38, 40, 82, 106, 110, 114, 118]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--conf", default="dtu", choices=["dtu", "bmvs"])
    p.add_argument("--scan_ids", type=int, nargs="+", default=None)
    p.add_argument("--expname", default="ours")
    p.add_argument("--exps_folder", default="exps_vsdf")
    p.add_argument("--evals_folder", default="exps_result")
    p.add_argument("--data_dir_root", default="data_s_volsdf")
    p.add_argument("--checkpoint", default="latest")
    p.add_argument("--timestamp", default="latest",
                   help="specific run-dir timestamp to evaluate")
    p.add_argument("--ckpt_dir", default="",
                   help="explicit run dir (containing checkpoints/)")
    p.add_argument("--split_n_pixels", type=int, default=16384,
                   help="rays per render chunk")
    p.add_argument("--gpu", default="auto",
                   help="accepted for compatibility; ignored (the device "
                        "is the card unless main() is given another)")
    p.add_argument("--eval_rendering", action="store_true")
    p.add_argument("--eval_mesh", action="store_true")
    p.add_argument("--result_from", default="None",
                   choices=["None", "default", "blend"])
    p.add_argument("--resolution", type=int, default=512)
    p.add_argument("--lpips_weights", default="")
    p.add_argument("--override", nargs="*", default=[])
    return p


def main(argv: Optional[List[str]] = None, *, device=None) -> List[Dict]:
    """Run the evaluation for argv on `device` ("cuda" by default;
    device="cpu" runs it on the CPU). Returns the metric results of
    --result_from runs, one per scan."""
    p = build_parser()
    opt = p.parse_args(argv)
    if opt.scan_ids is None:
        opt.scan_ids = DTU_SCANS if opt.conf == "dtu" else list(range(1, 10))
    # --ckpt_dir names ONE run dir; applying it to a scan list would
    # evaluate every scan against the same weights.
    if opt.ckpt_dir and len(opt.scan_ids) != 1:
        p.error(f"--ckpt_dir points at a single run dir; pass exactly "
                f"one --scan_ids with it (got {len(opt.scan_ids)} scans)")
    with launched(device) as device:
        return _evaluate(opt, resolve_device(device, "eval_vsdf"))


def _evaluate(opt, device) -> List[Dict]:

    cfg = load_config(opt.conf, overrides=list(opt.override))
    cfg.data_dir_root = opt.data_dir_root
    cfg.dataset.data_dir_root = opt.data_dir_root

    all_results = []
    for scan_id in opt.scan_ids:
        expdir = os.path.join(opt.exps_folder, f"{opt.expname}_{scan_id}")
        ckpt_path = find_checkpoint(expdir, opt.checkpoint,
                                    timestamp=opt.timestamp,
                                    ckpt_dir=opt.ckpt_dir)
        if ckpt_path is None:
            logger.warning(f"no checkpoint for scan{scan_id} in {expdir}")
            continue
        logger.info(f"scan{scan_id}: checkpoint {ckpt_path}")
        scene = load_scene(cfg.dataset.data_dir, tuple(cfg.dataset.img_res),
                           scan_id, -1, cfg.data_dir_root)
        params = load_trained_params(cfg, ckpt_path, device)

        evaldir = os.path.join(opt.evals_folder,
                               f"{cfg.train.expname}_{scan_id}")
        meta_path = os.path.join(ckpt_path, "meta.json")
        epoch = 0
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                epoch = json.load(f).get("epoch", 0)
        images_dir = os.path.join(evaldir, f"rendering_{epoch}")
        os.makedirs(images_dir, exist_ok=True)

        if opt.eval_mesh:
            bbs = os.path.join(cfg.data_dir_root, "DTU", "bbs.npz") \
                if opt.conf == "dtu" else None
            mesh_dir = os.path.join(evaldir, "mesh")
            os.makedirs(mesh_dir, exist_ok=True)
            export_mesh(cfg, scene, params,
                        os.path.join(mesh_dir, f"scan{scan_id}.ply"),
                        resolution=opt.resolution, bbs_file=bbs)

        if opt.eval_rendering:
            if opt.result_from == "None":
                render_eval_views(cfg, scene, params, images_dir,
                                  chunk=opt.split_n_pixels)
            else:
                res = eval_rendered_views(
                    cfg, scene, images_dir, result_from=opt.result_from,
                    lpips_weights=opt.lpips_weights or None, device=device)
                all_results.append(res)
                print(f"SCAN {scan_id}:")
                for k in ("psnr", "ssim", "lpips"):
                    m, s = res[f"{k}_mean"], res[f"{k}_std"]
                    if m is not None:
                        print(f"    {k} mean = {m:.4f}, std {s:.4f}")

    for k in ("psnr", "ssim", "lpips"):
        vals = [r[f"{k}_mean"] for r in all_results
                if r[f"{k}_mean"] is not None]
        if vals:
            print(f"ALL {k}: {np.mean(vals):.4f}")
    return all_results


def cli() -> None:
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main(sys.argv[1:])


if __name__ == "__main__":
    cli()
