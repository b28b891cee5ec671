"""Image-based rendering of novel views (counterpart of
s_volsdf_tpu/engine/ibr.py:30-200): warp the training images into an
eval view through the depth maps, weight each by the cosine between its
viewing direction and the eval view's (a softmax at 20x), fall back on
the VolSDF render where no training view passes the geometric check,
erode the warp masks and blend across a 4-level Laplacian pyramid.

The JAX package does this on the host with cv2 and numpy; here it runs
in torch on the device the caller names ("cuda" by default). The
geometric check is fusion's (`check_geometric_consistency`, the kernel
`csrc/fusion.cu` on CUDA depths), with its source x/y; the cv2
operations are `utils.image`'s, float64 kept float64. The blends and
`create_scene`'s images are written as PNG.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.config import Config
from s_volsdf_tpu_torch.data.io import (read_camera_parameters, read_img,
                                        read_pfm, write_cam, write_png)
from s_volsdf_tpu_torch.data.mvs_dataset import MVSDataset
from s_volsdf_tpu_torch.data.splits import get_eval_ids, get_trains_ids
from s_volsdf_tpu_torch.engine.fusion import check_geometric_consistency
from s_volsdf_tpu_torch.utils.device import resolve_device
from s_volsdf_tpu_torch.utils.image import (add, erode5, pyr_down, pyr_up,
                                            remap_cubic, subtract)

logger = logging.getLogger("s_volsdf_tpu_torch")

BLEND_LEVELS = 4
FILTER_DIST = 2.0      # the geometric check's pixel bound for IBR
FILTER_DIFF = 0.01     # ... and its relative depth bound
SOFTMAX_SCALE = 20.0
RENDER_WEIGHT = 0.2    # the VolSDF render's fallback weight
MASK_THRESHOLD = 0.2   # warp weights eroded below this
RENDER_FLOOR = 1e-2    # added to the render's blending weight


def create_scene(cfg: Config, scene: str, exps_root: str = ".") -> None:
    """Write the cams of the scene's training and eval views, and the
    images of its training views (PNG), under <exps_root>/<cfg.outdir>/
    <scene>/, for image-based rendering."""
    outdir = os.path.join(exps_root, cfg.outdir)
    os.makedirs(os.path.join(outdir, scene), exist_ok=True)
    data_dir = cfg.dataset.data_dir
    trains_i = get_trains_ids(data_dir, scene, cfg.num_view)
    evals_i = get_eval_ids(data_dir, int(scene[4:]))
    ds = MVSDataset(
        datapath=os.path.join(cfg.data_dir_root, data_dir, "mvs_data"),
        scan=scene, nviews=cfg.num_view, data_dir=data_dir,
        ndepths=cfg.mvs.numdepth,
        interval_scale=cfg.mvs.interval_scale if data_dir == "DTU" else 1.0,
        max_h=cfg.max_h, max_w=cfg.max_w, trains_i=trains_i + evals_i,
        data_dir_root=cfg.data_dir_root, x2_mvsres=False)
    for i in range(len(ds)):
        s = ds[i]
        write_cam(os.path.join(outdir, s.filename.format("cams", "_cam.txt")),
                  np.asarray(s.proj_matrices["stage3"][0]), s.cam_near_far)
        if s.view_ids[0] not in evals_i:
            img = (np.clip(s.imgs[0], 0, 1) * 255).astype(np.uint8)
            write_png(os.path.join(outdir, s.filename.format("images", ".png")),
                      img)
    logger.info(f"create_scene: wrote cams/images for {scene} to {outdir}")


# --------------------------------------------------------------------------
# Laplacian blending
# --------------------------------------------------------------------------

def _laplacian_pyramid(img: torch.Tensor, num_levels: int, is_mask: bool
                       ) -> List[torch.Tensor]:
    """Levels coarse to fine: a mask's Gaussian levels, an image's
    Laplacian ones (its coarsest Gaussian level first)."""
    gp = [img.to(torch.float64)]
    for _ in range(num_levels):
        gp.append(pyr_down(gp[-1]))
    if is_mask:
        return [gp[i] for i in range(num_levels - 1, -1, -1)]
    lp = [gp[num_levels - 1]]
    for i in range(num_levels - 1, 0, -1):
        lp.append(subtract(gp[i - 1], pyr_up(gp[i])))
    return lp


def laplacian_blending(imgs: torch.Tensor, masks: torch.Tensor,
                       num_levels: int = BLEND_LEVELS) -> torch.Tensor:
    """Blend N images (N, H, W, C) by N masks of the same shape across a
    Laplacian pyramid; float64, clipped to [0, 1]. The pyramids of all N
    are built at once."""
    if imgs.shape != masks.shape:
        raise ValueError(f"laplacian_blending: images {tuple(imgs.shape)}, "
                         f"masks {tuple(masks.shape)}")
    lp_imgs = _laplacian_pyramid(imgs, num_levels, False)
    lp_masks = _laplacian_pyramid(masks, num_levels, True)
    levels = []
    for lvl in range(num_levels):
        acc = 0
        for j in range(imgs.shape[0]):
            acc = acc + lp_masks[lvl][j] * lp_imgs[lvl][j]
        levels.append(acc)
    out = levels[0]
    for lvl in range(1, num_levels):
        out = add(pyr_up(out), levels[lvl])
    return out.clamp(0.0, 1.0)


def _dirs_for_view(intrinsics3: np.ndarray, extrinsics: np.ndarray, hw,
                   device) -> Tuple[torch.Tensor, np.ndarray]:
    """Per-pixel unit ray directions in world space, (H, W, 3) float32
    on `device` (computed in float64 from the float32 cameras, as the
    JAX package does with numpy), and the camera centre."""
    h, w = hw
    pose = np.linalg.inv(extrinsics)
    ys = torch.arange(h, dtype=torch.float64, device=device)[:, None].expand(h, w)
    xs = torch.arange(w, dtype=torch.float64, device=device)[None, :].expand(h, w)
    fx, fy = intrinsics3[0, 0], intrinsics3[1, 1]
    cx, cy = intrinsics3[0, 2], intrinsics3[1, 2]
    sk = intrinsics3[0, 1]
    # numpy's promotions: the scalars' own product in the cameras' dtype,
    # the rest in float64.
    x_lift = (xs - float(cx) + float(cy * sk / fy)
              - float(sk) * ys / float(fy)) / float(fx)
    y_lift = (ys - float(cy)) / float(fy)
    pts = torch.stack([x_lift, y_lift, torch.ones_like(x_lift)], dim=-1)
    rot = torch.as_tensor(pose[:3, :3].astype(np.float64), device=device)
    world = pts @ rot.T
    dirs = world / torch.linalg.norm(world, dim=-1, keepdim=True)
    return dirs.to(torch.float32), pose[:3, 3]


def view_inputs(scan_folder: str, out_folder: str, vid: int, device,
                image: bool) -> Dict:
    """View `vid`'s cameras, depth and ray directions (and, with `image`,
    its training image) on `device`: what `blend_view` takes."""
    intr, extr = read_camera_parameters(
        os.path.join(scan_folder, f"cams/{vid:08d}_cam.txt"))
    depth = read_pfm(os.path.join(out_folder, f"depth_est/{vid:08d}.pfm"))[0]
    view = {"intr": intr, "extr": extr,
            "depth": torch.as_tensor(np.ascontiguousarray(depth),
                                     device=device)}
    view["dirs"] = _dirs_for_view(intr, extr, depth.shape, device)[0]
    if image:
        view["image"] = torch.as_tensor(read_img(os.path.join(
            scan_folder, f"images/{vid:08d}.png")), device=device)
    return view


def blend_view(ref: Dict, render: torch.Tensor, srcs: List[Dict]
               ) -> torch.Tensor:
    """The blended eval view (H, W, 3) float64 in [0, 1]: each source
    view warped into `ref` through the geometric check's source x/y,
    weighted by the cosine of its viewing direction, the render `render`
    (H, W, 3) as the fallback layer."""
    weight_masks, sampled_srcs = [], []
    for src in srcs:
        if src["depth"].shape != ref["depth"].shape:
            raise ValueError(f"IBR: source depth {tuple(src['depth'].shape)}, "
                             f"eval depth {tuple(ref['depth'].shape)}")
        geo_mask, _, x2d, y2d = check_geometric_consistency(
            ref["depth"], ref["intr"], ref["extr"], src["depth"],
            src["intr"], src["extr"], filter_dist=FILTER_DIST,
            filter_diff=FILTER_DIFF)
        x2d, y2d = x2d.to(torch.float32), y2d.to(torch.float32)
        sampled_srcs.append(remap_cubic(src["image"], x2d, y2d))
        sampled_dir = remap_cubic(src["dirs"], x2d, y2d)
        sampled_dir = sampled_dir / torch.linalg.norm(sampled_dir, dim=2,
                                                      keepdim=True)
        cos_dir = torch.nan_to_num((sampled_dir * ref["dirs"]).sum(dim=2))
        weight_masks.append(cos_dir * geo_mask.to(torch.float64))
    weight_masks.append(torch.full(ref["depth"].shape, RENDER_WEIGHT,
                                   dtype=torch.float64,
                                   device=ref["depth"].device))
    sampled_srcs.append(render)

    wm = SOFTMAX_SCALE * torch.stack(weight_masks)
    wm = torch.exp(wm - wm.max(dim=0, keepdim=True).values)
    wm = wm / wm.sum(dim=0, keepdim=True)
    wm = wm[..., None].repeat(1, 1, 1, 3)
    images = torch.stack(sampled_srcs)

    # Fill undefined pixels from the render; erode the warp masks so the
    # pyramid's blur does not bleed their holes.
    filled = images * wm + images[-1:] * (1 - wm)
    wm_lap = wm.clone()
    eroded = erode5((wm_lap[:-1] > MASK_THRESHOLD).to(torch.float64))
    wm_lap[:-1] = eroded * wm_lap[:-1]
    wm_lap[-1] += RENDER_FLOOR
    wm_lap = wm_lap / wm_lap.sum(dim=0, keepdim=True)
    return laplacian_blending(filled, wm_lap, num_levels=BLEND_LEVELS)


def image_based_render(scan_folder: str, out_folder: str, data_dir: str,
                       num_view: int = 3, *, device=None) -> List[str]:
    """Blend warped training views into each eval view of the scan, on
    `device` ("cuda" by default). Reads scan_folder/cams/*_cam.txt,
    scan_folder/images/*.png (the training views), out_folder/eval_XXX.png
    (the VolSDF renders) and out_folder/depth_est/*.pfm (every view);
    writes out_folder/eval_blend_XXX.png and returns their paths."""
    dev = resolve_device(device, "image_based_render")
    scan = Path(scan_folder).name
    trains_i = get_trains_ids(data_dir, scan, num_view)
    evals_i = get_eval_ids(data_dir, int(scan[4:]))
    srcs = [view_inputs(scan_folder, out_folder, v, dev, image=True)
            for v in trains_i]
    written = []
    for ref_view in evals_i:
        ref = view_inputs(scan_folder, out_folder, ref_view, dev, image=False)
        render = torch.as_tensor(read_img(os.path.join(
            out_folder, f"eval_{ref_view:03d}.png")), device=dev)
        blend = blend_view(ref, render, srcs)
        out_path = os.path.join(out_folder, f"eval_blend_{ref_view:03d}.png")
        write_png(out_path, (blend * 255).to(torch.uint8).cpu().numpy())
        written.append(out_path)
        logger.info(f"IBR: wrote {out_path}")
    return written
