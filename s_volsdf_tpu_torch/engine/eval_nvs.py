"""Novel-view evaluation and mesh export (counterpart of
s_volsdf_tpu/engine/eval_nvs.py):

- `find_checkpoint`: the newest timestamped run that holds the
  checkpoint (or the run a timestamp or run directory names);
- `load_trained_params`: its VolSDF parameters, with the background
  MLPs for a background model;
- `render_eval_views`: each eval view (and the first three training
  views) rendered with `render_image` (a background model through the
  view's nearest training view's directions), written as
  eval_{vid:03d}.png, normal_{vid:03d}.png and depth_est/{vid:08d}.pfm
  (depth x scale_factor);
- `eval_rendered_views`: masked PSNR, SSIM and (with weights) LPIPS of
  the written renders against the scene's images (DTU or BlendedMVS
  masks);
- `export_mesh`: the SDF's surface (`engine.mesh`, the fused kernel on
  the card; unclamped for a background model), its largest component,
  mapped to world units by the scene's scale_mat, as a PLY with faces.

Under a process group the renders and the SDF grids are sharded over
`parallel.mesh.eval_group` (where the JAX package passes `eval_mesh`),
and only the node's first rank writes the files.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from s_volsdf_tpu_torch.config import Config, check_ported
from s_volsdf_tpu_torch.data.io import read_png, save_pfm, save_ply, write_png
from s_volsdf_tpu_torch.data.scene_dataset import SceneData
from s_volsdf_tpu_torch.data.splits import get_trains_ids
from s_volsdf_tpu_torch.engine.mesh import (LAUNCH_POINTS,
                                            extract_mesh_by_grid,
                                            extract_mesh_high_res,
                                            largest_component, mesh_sdf_fn)
from s_volsdf_tpu_torch.engine.render import render_image
from s_volsdf_tpu_torch.engine.train_step import init_train_state, make_optimizer
from s_volsdf_tpu_torch.models.lpips import load_lpips, lpips_distance
from s_volsdf_tpu_torch.models.network import VolSDFParams, init_volsdf_params
from s_volsdf_tpu_torch.models.network_bg import init_volsdf_bg_params
from s_volsdf_tpu_torch.parallel.mesh import eval_group, is_writer
from s_volsdf_tpu_torch.utils import checkpoint as ckpt
from s_volsdf_tpu_torch.utils.metrics import masked_psnr, ssim

logger = logging.getLogger("s_volsdf_tpu_torch")


def dtu_bbs_lookup(bbs, scan_id: int) -> np.ndarray:
    """A DTU scan's bounding box from bbs.npz: scan 82 takes scan 83's,
    scans 21, 34 and 38 take scan 24's; keys str(id) or "scan{id}"."""
    sid = int(scan_id)
    if sid == 82:
        sid = 83
    elif sid in (21, 34, 38):
        sid = 24
    key = str(sid) if str(sid) in bbs.files else f"scan{sid}"
    return bbs[key]


def find_checkpoint(expdir: str, checkpoint: str = "latest",
                    timestamp: str = "latest",
                    ckpt_dir: str = "") -> Optional[str]:
    """The checkpoint directory to evaluate, or None: with `ckpt_dir`,
    <ckpt_dir>/checkpoints/<checkpoint>; with a `timestamp`, that run's;
    otherwise the newest run under `expdir` that holds it."""
    if ckpt_dir:
        path = os.path.join(ckpt_dir, "checkpoints", checkpoint)
        return path if os.path.exists(os.path.join(path, ckpt.STATE_FILE)) \
            else None
    if not os.path.isdir(expdir):
        return None
    candidates = sorted(os.listdir(expdir), reverse=True) \
        if timestamp == "latest" else [timestamp]
    for ts in candidates:
        path = os.path.join(expdir, ts, "checkpoints", checkpoint)
        if os.path.exists(os.path.join(path, ckpt.STATE_FILE)):
            return path
    return None


def load_trained_params(cfg: Config, ckpt_path: str, device) -> VolSDFParams:
    """The VolSDF parameters of a checkpoint (the port's or the JAX
    package's), on `device`; with the background MLPs for a background
    model."""
    check_ported(cfg)
    init = (init_volsdf_bg_params if cfg.model.with_background
            else init_volsdf_params)
    params = init(torch.Generator().manual_seed(cfg.seed), cfg.model, device)
    state = init_train_state(cfg, params, make_optimizer(cfg, params))
    leaves, _, _ = ckpt.load_state(ckpt_path, ckpt.train_state_leaves(state))
    ckpt.restore_train_state(state, leaves)
    return state.params


def _to_png(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def render_eval_views(cfg: Config, scene: SceneData, params: VolSDFParams,
                      images_dir: str, *, include_train: bool = True,
                      chunk: int = 16384) -> List[int]:
    """Render the eval views (and the first three training views of the
    3-view protocol) and write their RGB, normal and scaled-depth files;
    returns the view ids."""
    writer = is_writer()
    if writer:
        os.makedirs(os.path.join(images_dir, "depth_est"), exist_ok=True)
    test_idx = scene.eval_ids()
    if include_train:
        test_idx = test_idx + get_trains_ids(
            scene.data_dir, f"scan{scene.scan_id}", 3)[:3]
    group = eval_group(cfg.parallel, chunk)
    for vid in test_idx:
        maps = render_image(params, cfg.model, scene.poses[vid],
                            scene.intrinsics[vid], scene.img_res,
                            chunk=chunk, fast=-1,
                            near_pose=scene.near_pose(vid), group=group)
        if not writer:
            continue
        write_png(os.path.join(images_dir, f"eval_{vid:03d}.png"),
                  _to_png(maps["rgb"]))
        write_png(os.path.join(images_dir, f"normal_{vid:03d}.png"),
                  _to_png((maps["normal"] + 1) / 2))
        save_pfm(os.path.join(images_dir, "depth_est", f"{vid:08d}.pfm"),
                 (maps["depth"] * scene.scale_factor).astype(np.float32))
        logger.info(f"rendered view {vid} -> {images_dir}")
    return test_idx


def eval_rendered_views(cfg: Config, scene: SceneData, images_dir: str,
                        result_from: str = "default",
                        lpips_weights: Optional[str] = None, *,
                        device=None,
                        seconds: Optional[List[float]] = None) -> Dict:
    """Masked PSNR, SSIM and LPIPS (None without weights) over the
    written renders of the eval views: "default" reads eval_*.png,
    "blend" eval_blend_*.png. SSIM and LPIPS compare the foregrounds
    composited on white, SSIM with data_range 2.0 (the float range
    scikit-image 0.17 assumed, which the published SSIMs used). LPIPS
    runs on `device` (the CPU by default). `seconds`, when given, gets
    each view's host seconds."""
    if scene.masks is None:
        raise ValueError("eval_rendered_views: the scene has no masks "
                         "(a synthetic scene)")
    H, W = scene.img_res
    prefix = "eval_blend_" if result_from == "blend" else "eval_"
    device = torch.device(device or "cpu")
    model = None
    if lpips_weights:
        model = load_lpips(lpips_weights, device)
        if model is None:
            logger.warning(f"no LPIPS weights at {lpips_weights}; "
                           "LPIPS skipped")

    psnrs, ssims, lpipss = [], [], []
    for vid in scene.eval_ids():
        path = os.path.join(images_dir, f"{prefix}{vid:03d}.png")
        if not os.path.exists(path):
            continue
        t0 = time.perf_counter()
        pred = read_png(path).astype(np.float32)[..., :3] / 255.0
        pred = pred.reshape(-1, 3)
        gt = scene.rgb[vid]
        mask = scene.masks[vid]
        psnrs.append(masked_psnr(pred, gt, mask))
        gt_fg = (gt * mask + (1 - mask)).reshape(H, W, 3)
        pred_fg = (pred * mask + (1 - mask)).reshape(H, W, 3)
        ssims.append(ssim(pred_fg, gt_fg, data_range=2.0))
        if model is not None:
            d = lpips_distance(
                model, torch.as_tensor(pred_fg, device=device)[None],
                torch.as_tensor(np.asarray(gt_fg, np.float32),
                                device=device)[None])
            lpipss.append(float(d[0]))
        if seconds is not None:
            seconds.append(time.perf_counter() - t0)

    def stat(vals, fn):
        return float(fn(vals)) if vals else None

    result = {"psnr_mean": stat(psnrs, np.mean), "psnr_std": stat(psnrs, np.std),
              "ssim_mean": stat(ssims, np.mean), "ssim_std": stat(ssims, np.std),
              "lpips_mean": stat(lpipss, np.mean),
              "lpips_std": stat(lpipss, np.std), "n_views": len(psnrs)}
    logger.info(f"NVS eval ({result_from}): {result}")
    return result


def export_mesh(cfg: Config, scene: SceneData, params: VolSDFParams,
                out_path: str, *, resolution: int = 512,
                bbs_file: Optional[str] = None,
                stats: Optional[Dict] = None) -> Optional[str]:
    """The SDF's marching-tetrahedra surface, its largest component, in
    world units (the scene's scale_mat), as a PLY with faces; None when
    the field has no surface. With a bbs.npz, the scan's box
    (`extract_mesh_by_grid`, higher_res); otherwise the two-pass
    extraction over plot.grid_boundary. `stats` gets each part's host
    seconds (`engine.mesh`'s lists, and "component" and "write" of this
    function) and the vertex and face counts."""
    bounding = 0.0 if (cfg.model.white_bkgd or cfg.model.with_background) \
        else cfg.model.scene_bounding_sphere
    sdf_fn = mesh_sdf_fn(params, cfg.model, bounding)
    group = eval_group(cfg.parallel, LAUNCH_POINTS)
    if bbs_file and os.path.exists(bbs_file):
        with np.load(bbs_file) as bbs:
            grid_params = dtu_bbs_lookup(bbs, scene.scan_id)
        mesh = extract_mesh_by_grid(grid_params, sdf_fn, resolution=resolution,
                                    level=cfg.plot.level, higher_res=True,
                                    stats=stats, group=group)
    else:
        mesh = extract_mesh_high_res(
            sdf_fn, resolution=resolution,
            grid_boundary=tuple(cfg.plot.grid_boundary), level=cfg.plot.level,
            stats=stats, group=group)
    if mesh is None:
        logger.warning("no surface found")
        return None
    if not is_writer():
        return out_path
    t0 = time.perf_counter()
    verts, faces = largest_component(*mesh)
    t1 = time.perf_counter()
    if scene.scale_mat is not None:
        hom = np.concatenate([verts, np.ones_like(verts[:, :1])], axis=-1)
        verts = (hom @ scene.scale_mat.T)[:, :3]
    save_ply(out_path, verts.astype(np.float32), faces=faces)
    if stats is not None:
        stats.setdefault("component", []).append(t1 - t0)
        stats["write"] = time.perf_counter() - t1
        stats["verts"], stats["faces"] = verts.shape[0], faces.shape[0]
    logger.info(f"mesh saved to {out_path} "
                f"({verts.shape[0]} verts, {faces.shape[0]} faces)")
    return out_path
