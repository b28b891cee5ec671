"""Multi-view geometric-consistency depth fusion into a point cloud
(counterpart of s_volsdf_tpu/engine/fusion.py:115-302).

Fusion runs where the depth maps are put: on "cuda" by default, where
the per-pair check is the kernel `csrc/fusion.cu`
(`ops.geo_consistency`); on the CPU, its plain version. The averaging,
the masks and the back-projection of the kept pixels are torch float64
ops on the same device, cast to float32 at the end as in the JAX
package. Images are read as `images/{v:08d}.png`, the port's own
lossless copies, else as `images/{v:08d}.jpg`, the JAX package's.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.data.io import (read_camera_parameters, read_image,
                                        read_img, read_pfm, save_ply)
from s_volsdf_tpu_torch.ops.geo_consistency import (geo_consistency,
                                                    pair_matrices,
                                                    reproject_plain)
from s_volsdf_tpu_torch.utils.device import resolve_device
from s_volsdf_tpu_torch.utils.image import (dilate_binary, ellipse_kernel,
                                            resize_linear)

logger = logging.getLogger("s_volsdf_tpu_torch")

EVAL_MASK_DILATION = 25   # disk(12) as cv2's 25x25 ellipse


def reproject_with_depth(depth_ref, intr_ref, extr_ref, depth_src,
                         intr_src, extr_src):
    """Project the reference depth into the source view, sample the
    source depth there and project it back: (reprojected reference
    depth, x and y in the reference after the round trip, source x and
    y), float64 tensors on the depths' device. Plain torch ops; the
    numbers are the host C++ core's."""
    return reproject_plain(torch.as_tensor(depth_ref),
                           torch.as_tensor(depth_src),
                           pair_matrices(intr_ref, extr_ref, intr_src,
                                         extr_src))


def check_geometric_consistency(depth_ref, intr_ref, extr_ref, depth_src,
                                intr_src, extr_src, filter_dist=1.0,
                                filter_diff=0.01, *, xy: bool = True):
    """A pixel passes if its round trip moves it less than `filter_dist`
    pixels and its relative depth difference is below `filter_diff`.
    Returns (mask, reprojected depth, 0 where the mask fails, source x,
    source y) as tensors on the depths' device; x and y are None
    without `xy`. Depths are tensors or arrays (arrays go to the CPU),
    cameras numpy. CUDA depths launch the kernel."""
    mats = pair_matrices(intr_ref, extr_ref, intr_src, extr_src)
    return geo_consistency(torch.as_tensor(depth_ref),
                           torch.as_tensor(depth_src), mats, filter_dist,
                           filter_diff, xy)


def _fraction(mask: torch.Tensor) -> float:
    return int(mask.sum()) / mask.numel()


def fuse_views(views: List[Dict], *, conf_thresh: float = 0.0,
               thres_view: int = 1, filter_dist: float = 1.0,
               filter_diff: float = 0.01,
               eval_masks: Optional[List] = None, device=None
               ) -> Tuple[np.ndarray, np.ndarray, List[Dict]]:
    """Fuse per-view depths into a point cloud.

    views: dicts with depth (H, W) float32, confidence (H, W),
      intrinsics (3, 3), extrinsics (4, 4), image (H, W, 3) in [0, 1].
    eval_masks: optional per-view foreground masks (already dilated and
      resized; a pixel counts where > 0), or None entries.
    device: where the fusion runs ("cuda" by default, raising without
      a card).
    Returns (xyz (N, 3) float32, rgb (N, 3) uint8, per-view fractions of
    pixels kept by the photometric, geometric and final masks)."""
    dev = resolve_device(device, "fuse_views")
    depths = [torch.as_tensor(v["depth"], device=dev) for v in views]
    vertices, colors, stats = [], [], []
    for ref_i, ref in enumerate(views):
        d_ref = depths[ref_i]
        photo_mask = torch.as_tensor(ref["confidence"], device=dev) > conf_thresh
        geo_sum = torch.zeros(d_ref.shape, dtype=torch.int32, device=dev)
        depth_sum = torch.zeros(d_ref.shape, dtype=torch.float64, device=dev)
        for src_i, src in enumerate(views):
            if src_i == ref_i:
                continue
            mask, depth_reproj, _, _ = check_geometric_consistency(
                d_ref, ref["intrinsics"], ref["extrinsics"], depths[src_i],
                src["intrinsics"], src["extrinsics"], filter_dist,
                filter_diff, xy=False)
            geo_sum += mask
            depth_sum = depth_sum + depth_reproj
        depth_avg = (depth_sum + d_ref.to(torch.float64)) / (geo_sum + 1)
        geo_mask = geo_sum >= thres_view
        final_mask = photo_mask & geo_mask
        if eval_masks is not None and eval_masks[ref_i] is not None:
            final_mask &= torch.as_tensor(eval_masks[ref_i], device=dev) > 0

        stats.append({"photo": _fraction(photo_mask),
                      "geo": _fraction(geo_mask),
                      "final": _fraction(final_mask)})
        logger.info(f"fusion ref {ref_i}: photo/geo/final = "
                    f"{stats[-1]['photo']:.3f}/{stats[-1]['geo']:.3f}/"
                    f"{stats[-1]['final']:.3f}")

        yv, xv = torch.nonzero(final_mask, as_tuple=True)
        dv = depth_avg[final_mask]
        pix = torch.stack([xv.to(torch.float64) * dv,
                           yv.to(torch.float64) * dv, dv])
        inv_k, inv_e = (torch.as_tensor(np.linalg.inv(ref[k]).astype(np.float64),
                                        device=dev)
                        for k in ("intrinsics", "extrinsics"))
        xyz_ref = inv_k @ pix
        vertices.append(
            (inv_e @ torch.cat([xyz_ref, torch.ones_like(dv)[None]]))[:3].T)
        color = torch.as_tensor(ref["image"], device=dev)[final_mask]
        colors.append((color.clamp(0, 1) * 255).to(torch.uint8))

    xyz = torch.cat(vertices).to(torch.float32).cpu().numpy()
    rgb = torch.cat(colors).cpu().numpy()
    return xyz, rgb, stats


def eval_mask_for(eval_mask_dir: str, v: int, shape_hw, device
                  ) -> Optional[torch.Tensor]:
    """View v's foreground mask under eval_mask_dir (mask/{v:08d}.png,
    mask/{v:03d}.png or {v:03d}.png; the last channel of a colour PNG),
    dilated with the 25x25 ellipse and resized linearly to shape_hw, as
    float32 on `device`; None when no file is there."""
    for pattern in (f"mask/{v:08d}.png", f"mask/{v:03d}.png", f"{v:03d}.png"):
        p = os.path.join(eval_mask_dir, pattern)
        if os.path.exists(p):
            m = read_image(p)
            if m.ndim == 3:
                m = m[..., -1]
            m = dilate_binary(torch.as_tensor(m, device=device) > 0,
                              ellipse_kernel(EVAL_MASK_DILATION))
            return resize_linear(m.to(torch.float32), shape_hw)
    return None


def load_views(scan_folder: str, out_folder: str, trains_i: List[int], *,
               eval_mask_dir: Optional[str] = None, device=None
               ) -> Tuple[List[Dict], List[Optional[torch.Tensor]]]:
    """The inputs of `fuse_views` from a scene's output directory: the
    depth and confidence PFMs under out_folder, cams/*_cam.txt and the
    images under scan_folder (images/*.png, the port's copies, else
    images/*.jpg, the JAX package's), and the eval masks (on `device`,
    "cuda" by default). A missing image raises naming both files."""
    dev = resolve_device(device, "load_views")
    views, eval_masks = [], []
    for v in trains_i:
        intr, extr = read_camera_parameters(
            os.path.join(scan_folder, f"cams/{v:08d}_cam.txt"))
        paths = [os.path.join(scan_folder, f"images/{v:08d}.{ext}")
                 for ext in ("png", "jpg")]
        img_path = next((p for p in paths if os.path.exists(p)), None)
        if img_path is None:
            raise FileNotFoundError(f"fusion reads the view's image from "
                                    f"{paths[0]} or {paths[1]}, neither of "
                                    f"which exists")
        img = read_img(img_path)
        depth = read_pfm(os.path.join(out_folder, f"depth_est/{v:08d}.pfm"))[0]
        conf = read_pfm(os.path.join(out_folder, f"confidence/{v:08d}.pfm"))[0]
        if depth.shape != img.shape[:2]:
            raise ValueError(f"view {v}: depth {depth.shape}, image "
                             f"{img.shape[:2]}")
        views.append({"depth": np.ascontiguousarray(depth),
                      "confidence": np.ascontiguousarray(conf),
                      "intrinsics": intr, "extrinsics": extr, "image": img})
        eval_masks.append(None if eval_mask_dir is None else
                          eval_mask_for(eval_mask_dir, v, depth.shape, dev))
    return views, eval_masks


def filter_depth(scan_folder: str, out_folder: str, plyfilename: str,
                 trains_i: List[int], *, conf_thresh: float = 0.0,
                 thres_view: int = 1, filter_dist: float = 1.0,
                 filter_diff: float = 0.01,
                 eval_mask_dir: Optional[str] = None, device=None) -> str:
    """File-level fusion: reads a scene's saved PFMs, cams and images
    (`load_views`), fuses them on `device` ("cuda" by default) and
    writes the PLY. Records the seconds of the reads, the fusion and
    the write in `filter_depth.last_seconds`."""
    dev = resolve_device(device, "filter_depth")
    t0 = time.perf_counter()
    views, eval_masks = load_views(scan_folder, out_folder, trains_i,
                                   eval_mask_dir=eval_mask_dir, device=dev)
    t1 = time.perf_counter()
    xyz, rgb, _ = fuse_views(
        views, conf_thresh=conf_thresh, thres_view=thres_view,
        filter_dist=filter_dist, filter_diff=filter_diff,
        eval_masks=eval_masks, device=dev)
    t2 = time.perf_counter()
    save_ply(plyfilename, xyz, rgb)
    filter_depth.last_seconds = {"read": t1 - t0, "fuse": t2 - t1,
                                 "write": time.perf_counter() - t2}
    logger.info(f"saved fused point cloud to {plyfilename} "
                f"({xyz.shape[0]} points)")
    return plyfilename


filter_depth.last_seconds = {}
