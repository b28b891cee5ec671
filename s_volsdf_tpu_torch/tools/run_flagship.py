"""Close-out of a `tools.run_100k` run: fusion and the Chamfer protocol,
then the NVS protocol on the held-out views (counterpart of
tools/run_flagship.py, on the port).

    python -m s_volsdf_tpu_torch.tools.run_flagship --exps /tmp/run100k \\
        --out runs/flagship_eval.json

It loads the run's latest checkpoint (`is_continue`), then:

1. renders the full-resolution feedback depth of each training view
   (`VolTrainer.render_mvs`), fuses them through the geometric-
   consistency filter (`engine.fusion.fuse_views`: the geo_consistency
   kernel on the card; the photometric mask open at confidence 1),
   writes <exps>/fused_flagship.ply and scores the cloud against the
   fixture's analytic sphere with the DTU Chamfer protocol
   (`engine.eval_geo.chamfer`: 0.2 mm downsampling, distances clipped at
   20 mm) in the fixture's mm frame, the ground truth being 1,000,000
   uniform sphere samples that a training camera sees;
2. renders the first --n-eval held-out views (`render_image`, fast=-1)
   as PNGs under <exps>/eval_renders and computes the masked PSNR and
   SSIM protocol against the fixture's held-out images
   (`engine.eval_nvs.eval_rendered_views`).

The JSON written to --out has the JAX tool's keys. The last lines
printed are the headline numbers with the card's name and power limit.
`main(argv, img_res=..., overrides=..., device=...)` runs it on a
fixture of another size (the CPU tests).
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from s_volsdf_tpu_torch.tools.run_100k import PRODUCTION_RES

GT_SAMPLES = 1_000_000
SPHERE_RADIUS = 0.8


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--exps", default="/tmp/run100k")
    ap.add_argument("--out", default="runs/flagship_eval.json")
    ap.add_argument("--n-eval", type=int, default=7,
                    help="distinct held-out views the fixture was built "
                         "with (make_dtu_fixture n_eval_views)")
    ap.add_argument("--world-scale", type=float, default=200.0)
    return ap


def visible_sphere_points(scene, train_ids, n: int = GT_SAMPLES,
                          radius: float = SPHERE_RADIUS) -> np.ndarray:
    """Uniform samples of the sphere (unit frame, seed 0) that some
    training camera sees: inside its image and on the side facing it
    (the ground truth's observation mask)."""
    H, W = scene.img_res
    rng = np.random.default_rng(0)
    g = rng.normal(size=(n, 3))
    g = g / np.linalg.norm(g, axis=1, keepdims=True) * radius
    visible = np.zeros(len(g), bool)
    for tid in train_ids:
        K, c2w = scene.intrinsics[tid], scene.poses[tid]
        w2c = np.linalg.inv(c2w)
        pc = g @ w2c[:3, :3].T + w2c[:3, 3]
        uvw = pc @ K[:3, :3].T
        u, v_ = uvw[:, 0] / uvw[:, 2], uvw[:, 1] / uvw[:, 2]
        in_img = (uvw[:, 2] > 0) & (u >= 0) & (u < W) & (v_ >= 0) & (v_ < H)
        front = ((g / radius) * (c2w[:3, 3] - g)).sum(1) > 0
        visible |= in_img & front
    return g[visible]


def run(args, *, img_res: Tuple[int, int] = PRODUCTION_RES,
        overrides: Sequence[str] = (), device=None) -> Dict:
    """The close-out of `args` (build_parser's); returns what it writes."""
    from s_volsdf_tpu_torch.config import load_config, per_scene_overrides
    from s_volsdf_tpu_torch.data.io import save_ply, write_png
    from s_volsdf_tpu_torch.data.splits import get_eval_ids, get_trains_ids
    from s_volsdf_tpu_torch.engine.eval_geo import chamfer
    from s_volsdf_tpu_torch.engine.eval_nvs import eval_rendered_views
    from s_volsdf_tpu_torch.engine.fusion import fuse_views
    from s_volsdf_tpu_torch.engine.render import render_image
    from s_volsdf_tpu_torch.engine.runner import setup_scene
    from s_volsdf_tpu_torch.utils.device import card_name, resolve_device

    dev = resolve_device(device, "run_flagship")
    root = os.path.join(args.exps, "data")
    H, W = img_res
    cfg = load_config("dtu", overrides=[
        f"data_dir_root={root}", f"dataset.data_dir_root={root}",
        "mvs.numdepth=192", f"dataset.img_res=[{H},{W}]", f"max_h={H}",
        f"max_w={W}", "is_continue=true"] + list(overrides))
    cfg = per_scene_overrides(cfg, "scan106")

    t_all = time.time()
    sc = setup_scene(cfg, "scan106", exps_root=args.exps, device=dev)
    trainer = sc["trainer"]
    scene = trainer.scene
    step = trainer.state.iter_step
    print(f"loaded checkpoint at step {step}", flush=True)
    if step <= 0:
        raise RuntimeError(f"no trained checkpoint found under {args.exps}")
    s = trainer.scale_factor
    if abs(s - args.world_scale) >= 1e-3:
        raise ValueError(f"scale factor {s}, --world-scale "
                         f"{args.world_scale}")

    # ---- 1. fusion + Chamfer protocol ----
    train_ids = get_trains_ids("DTU", "scan106", 3)
    t0 = time.time()
    views = []
    for tid in train_ids:
        depth_mm = trainer.render_mvs(tid)          # metric, far-pushed
        views.append({
            "depth": depth_mm / s,                  # normalized frame
            "confidence": np.ones_like(depth_mm),
            "intrinsics": scene.intrinsics[tid][:3, :3].copy(),
            "extrinsics": np.linalg.inv(scene.poses[tid]),
            "image": scene.rgb[tid].reshape(H, W, 3),
        })
    t_render_depth = time.time() - t0
    xyz, rgb, fstats = fuse_views(views, conf_thresh=0.0, thres_view=1,
                                  filter_dist=1.0, filter_diff=0.01,
                                  device=dev)
    ply_path = os.path.join(args.exps, "fused_flagship.ply")
    save_ply(ply_path, xyz * s, rgb)
    print(f"fused {len(xyz)} points -> {ply_path}", flush=True)

    gt = visible_sphere_points(scene, train_ids)
    cham = chamfer(xyz * s, gt * s, max_dist=20.0, downsample=0.2)
    radial = np.abs(np.linalg.norm(xyz, axis=1) - SPHERE_RADIUS) * s
    radial = radial[radial < 20.0]
    print(f"Chamfer: acc={cham['acc']:.4f} comp={cham['comp']:.4f} "
          f"overall={cham['overall']:.4f} mm "
          f"(radial {radial.mean():.4f} mm)", flush=True)

    # ---- 2. NVS eval protocol on the held-out views ----
    eval_ids = get_eval_ids("DTU")[:args.n_eval]
    images_dir = os.path.join(args.exps, "eval_renders")
    os.makedirs(images_dir, exist_ok=True)
    t0 = time.time()
    for vid in eval_ids:
        maps = render_image(trainer.state.params, cfg.model,
                            scene.poses[vid], scene.intrinsics[vid],
                            scene.img_res, chunk=16384, fast=-1, device=dev)
        pred = np.clip(maps["rgb"], 0, 1).reshape(H, W, 3)
        write_png(os.path.join(images_dir, f"eval_{vid:03d}.png"),
                  (pred * 255).astype(np.uint8))
        print(f"rendered eval view {vid}", flush=True)
    t_render_eval = time.time() - t0
    nvs = eval_rendered_views(cfg, scene, images_dir)

    out = {
        "step": step,
        "protocol": {
            "img_res": [H, W], "world_scale": s,
            "fusion": {"conf_thresh": 0.0, "thres_view": 1,
                       "filter_dist": 1.0, "filter_diff": 0.01},
            "chamfer": {"downsample_mm": 0.2, "max_dist_mm": 20.0,
                        "gt": f"{len(gt)} visible sphere samples"},
            "nvs": {"eval_ids": eval_ids, "fast": -1,
                    "masked_psnr": True, "ssim_data_range": 2.0},
        },
        "fusion_stats": fstats,
        "n_fused_points": int(len(xyz)),
        "chamfer_mm": {k: round(float(cham[k]), 4)
                       for k in ("acc", "comp", "overall")},
        "radial_mm": round(float(radial.mean()), 4),
        "nvs": nvs,
        "wall_s": {"depth_renders": round(t_render_depth, 1),
                   "eval_renders": round(t_render_eval, 1),
                   "total": round(time.time() - t_all, 1)},
    }
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(json.dumps({"chamfer_overall_mm": out["chamfer_mm"]["overall"],
                      "psnr": nvs["psnr_mean"], "ssim": nvs["ssim_mean"],
                      "card": card_name(dev)}), flush=True)
    print(f"wrote {args.out}", flush=True)
    return out


def main(argv: Optional[List[str]] = None, **kw) -> Dict:
    return run(build_parser().parse_args(argv), **kw)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, format="%(message)s")
    main()
