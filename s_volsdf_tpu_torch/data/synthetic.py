"""Synthetic sphere scenes and informative MVS probability volumes
(numpy; the same functions and outputs as s_volsdf_tpu/data/synthetic.py,
which tests/test_torch_config.py holds bit-equal).

The port keeps its own copy so that it runs where importing the JAX
package would import JAX.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class SyntheticScene:
    """A ring of pinhole cameras looking at a sphere at the origin."""
    intrinsics: np.ndarray   # (V, 4, 4)
    poses: np.ndarray        # (V, 4, 4) camera-to-world
    images: np.ndarray       # (V, H, W, 3) float32 in [0, 1]
    depths: np.ndarray       # (V, H, W) z-depth of the sphere (inf = miss)
    img_res: tuple
    sphere_radius: float
    scale_factor: float = 1.0


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Camera-to-world with +z forward (OpenCV convention)."""
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = eye
    return c2w


def ray_sphere_depth(origins, dirs, radius):
    """Analytic first-hit distance along unit `dirs` (inf on miss)."""
    b = np.sum(origins * dirs, axis=-1)
    c = np.sum(origins * origins, axis=-1) - radius ** 2
    disc = b * b - c
    hit = disc >= 0
    t = -b - np.sqrt(np.maximum(disc, 0.0))
    return np.where(hit & (t > 0), t, np.inf)


def _pixel_dirs(c2w, K, H, W):
    """Camera-frame and unit world directions of every pixel centre."""
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    x_lift = (xs - K[0, 2]) / K[0, 0]
    y_lift = (ys - K[1, 2]) / K[1, 1]
    dirs_cam = np.stack([x_lift, y_lift, np.ones_like(x_lift)], axis=-1)
    dirs = dirs_cam @ c2w[:3, :3].T
    dirs = dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs_cam, dirs


def make_sphere_scene(n_views: int = 3, img_res=(64, 96),
                      sphere_radius: float = 0.8,
                      cam_radius: float = 2.2,
                      light_dir=(0.3, -0.5, -0.8)) -> SyntheticScene:
    """Render a diffuse sphere from `n_views` cameras on an arc."""
    H, W = img_res
    f = 0.9 * max(H, W)
    K = np.eye(4, dtype=np.float32)
    K[0, 0], K[1, 1] = f, f
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0

    light = np.asarray(light_dir, dtype=np.float32)
    light = light / np.linalg.norm(light)

    intrinsics, poses, images, depths = [], [], [], []
    for v in range(n_views):
        ang = 2 * np.pi * v / max(n_views, 1) * 0.25
        eye = np.array([cam_radius * np.sin(ang), 0.35 * cam_radius,
                        -cam_radius * np.cos(ang)], dtype=np.float32)
        c2w = look_at(eye, np.zeros(3, dtype=np.float32),
                      np.array([0.0, 1.0, 0.0], dtype=np.float32))
        dirs_cam, dirs = _pixel_dirs(c2w, K, H, W)
        origins = np.broadcast_to(c2w[:3, 3], dirs.shape)

        t = ray_sphere_depth(origins.reshape(-1, 3), dirs.reshape(-1, 3),
                             sphere_radius).reshape(H, W)
        hit = np.isfinite(t)
        pts = origins + np.where(hit, t, 0.0)[..., None] * dirs
        normal = pts / np.maximum(
            np.linalg.norm(pts, axis=-1, keepdims=True), 1e-8)
        lambert = np.clip(-np.sum(normal * light, axis=-1), 0.0, 1.0)
        base = np.array([0.85, 0.45, 0.3], dtype=np.float32)
        img = np.where(hit[..., None],
                       (0.15 + 0.85 * lambert[..., None]) * base,
                       np.array([0.05, 0.05, 0.08], dtype=np.float32))
        z_depth = np.where(hit, t * (dirs_cam / np.linalg.norm(
            dirs_cam, axis=-1, keepdims=True))[..., 2], np.inf)

        intrinsics.append(K.copy())
        poses.append(c2w)
        images.append(img.astype(np.float32))
        depths.append(z_depth.astype(np.float32))

    return SyntheticScene(
        intrinsics=np.stack(intrinsics),
        poses=np.stack(poses),
        images=np.stack(images),
        depths=np.stack(depths),
        img_res=(H, W),
        sphere_radius=sphere_radius,
    )


def gt_prob_volume(c2w: np.ndarray, K: np.ndarray, res,
                   depth_values: np.ndarray, scale_factor: float,
                   sphere_radius: float = 0.8,
                   sigma_intervals: float = 1.5,
                   floor: float = 0.05,
                   inverse_depth: bool = False,
                   depth_noise: float = 0.0,
                   rng: "np.random.Generator | None" = None):
    """Probability volume a trained cascade would emit for the analytic
    sphere: per-pixel Gaussian bumps at the ground-truth z-depth over
    the hypothesis grid, mixed with a uniform floor.

    Returns (prob (D, H, W) float32 normalised over D, hyp (D,) the
    metric hypothesis grid used — uniform in 1/z with inverse_depth)."""
    H, W = res
    dvals = np.asarray(depth_values, np.float64)
    if inverse_depth:
        dvals = 1.0 / np.linspace(1.0 / dvals[0], 1.0 / dvals[-1],
                                  len(dvals))
    dirs_cam, dirs_u = _pixel_dirs(c2w, K, H, W)
    origins = np.broadcast_to(c2w[:3, 3], dirs_u.shape)
    t = ray_sphere_depth(origins.reshape(-1, 3), dirs_u.reshape(-1, 3),
                         sphere_radius).reshape(H, W)
    hit = np.isfinite(t)
    unit_z = (dirs_cam / np.linalg.norm(dirs_cam, axis=-1,
                                        keepdims=True))[..., 2]
    z = np.where(hit, t * unit_z, 0.0) * scale_factor
    if depth_noise > 0.0:
        rng = rng if rng is not None else np.random.default_rng(0)
        z = z + rng.normal(0.0, depth_noise, size=z.shape)
    sigma = sigma_intervals * max(float(np.median(np.abs(np.diff(dvals)))),
                                  1e-6)
    gauss = np.exp(-0.5 * ((dvals[:, None, None] - z[None]) / sigma) ** 2)
    gauss = np.where(hit[None], gauss, 1.0)
    gauss = gauss / np.clip(gauss.sum(axis=0, keepdims=True), 1e-12, None)
    prob = (1.0 - floor) * gauss + floor / len(dvals)
    return prob.astype(np.float32), dvals.astype(np.float32)


def sphere_radial_error(c2w: np.ndarray, K: np.ndarray, res,
                        depth_metric: np.ndarray, scale_factor: float,
                        sphere_radius: float = 0.8):
    """(mean, median, n_pixels) of a rendered z-depth map's distance to
    the analytic sphere: each pixel that hits the sphere is lifted to a
    point in the unit frame at the rendered depth, and its | ||p|| - r |
    is given in metric units (the fixture's DTU-like mm). Every such
    point's distance to the surface is its radial offset, so this stands
    in for the DTU Chamfer protocol on a synthetic scene."""
    H, W = res
    dirs_cam, dirs_u = _pixel_dirs(c2w, K, H, W)
    origins = np.broadcast_to(c2w[:3, 3], dirs_u.shape)
    t_gt = ray_sphere_depth(origins.reshape(-1, 3), dirs_u.reshape(-1, 3),
                            sphere_radius).reshape(H, W)
    hit = np.isfinite(t_gt)
    unit_z = (dirs_cam / np.linalg.norm(dirs_cam, axis=-1,
                                        keepdims=True))[..., 2]
    t_pred = (np.asarray(depth_metric) / scale_factor) / unit_z
    pts = origins + t_pred[..., None] * dirs_u
    radial = np.abs(np.linalg.norm(pts, axis=-1) - sphere_radius)
    err = radial[hit] * scale_factor
    return float(err.mean()), float(np.median(err)), int(hit.sum())


def sample_rays(scene: SyntheticScene, rng: np.random.Generator,
                view_idx: int, n_rays: int):
    """A random pixel batch of one view: (uv (n, 2) float32 pixel
    coordinates, rgb (n, 3)), pixels drawn with replacement."""
    H, W = scene.img_res
    idx = rng.integers(0, H * W, size=n_rays)
    ys, xs = np.divmod(idx, W)
    uv = np.stack([xs, ys], axis=-1).astype(np.float32)
    rgb = scene.images[view_idx].reshape(-1, 3)[idx]
    return uv, rgb
