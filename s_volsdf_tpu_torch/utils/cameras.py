"""Camera math: ray generation, bounding-sphere intersections and the
projection-matrix decomposition (counterpart of
s_volsdf_tpu/utils/cameras.py:14-96)."""

from __future__ import annotations

import numpy as np
import scipy.linalg
import torch


def lift(x, y, z, intrinsics):
    """Back-project pixel coords to camera space, with skew.

    x, y, z: (..., N); intrinsics: (..., 4, 4). Returns (..., N, 4)."""
    fx = intrinsics[..., 0, 0:1]
    fy = intrinsics[..., 1, 1:2]
    cx = intrinsics[..., 0, 2:3]
    cy = intrinsics[..., 1, 2:3]
    sk = intrinsics[..., 0, 1:2]

    x_lift = (x - cx + cy * sk / fy - sk * y / fy) / fx * z
    y_lift = (y - cy) / fy * z
    return torch.stack([x_lift, y_lift, z, torch.ones_like(z)], dim=-1)


def get_camera_params(uv, pose, intrinsics):
    """uv: (B, N, 2); pose (camera-to-world), intrinsics: (B, 4, 4).
    Returns (ray_dirs (B, N, 3) unit-norm world, cam_loc (B, 3))."""
    cam_loc = pose[..., :3, 3]
    x_cam = uv[..., 0]
    y_cam = uv[..., 1]
    z_cam = torch.ones_like(x_cam)

    pts_cam = lift(x_cam, y_cam, z_cam, intrinsics)
    world = torch.einsum("bij,bnj->bni", pose[..., :3, :3], pts_cam[..., :3])
    world = world + cam_loc[..., None, :]

    ray_dirs = world - cam_loc[..., None, :]
    ray_dirs = ray_dirs / torch.linalg.norm(ray_dirs, dim=-1, keepdim=True)
    return ray_dirs, cam_loc


def depth_scale_factor(uv, intrinsics):
    """z-component of camera-frame unit ray dirs (distance along the ray
    -> z-depth). Returns (B, N, 1)."""
    x_cam = uv[..., 0]
    y_cam = uv[..., 1]
    z_cam = torch.ones_like(x_cam)
    pts = lift(x_cam, y_cam, z_cam, intrinsics)[..., :3]
    dirs = pts / torch.linalg.norm(pts, dim=-1, keepdim=True)
    return dirs[..., 2:3]


def get_sphere_intersections(cam_loc, ray_dirs, r=1.0):
    """Near/far distances of rays (N, 3) to a sphere of radius r, clamped
    at 0. Returns (N, 2); a ray that misses gets its closest approach."""
    ray_cam_dot = torch.sum(ray_dirs * cam_loc, dim=-1, keepdim=True)
    under_sqrt = ray_cam_dot ** 2 - (
        torch.sum(cam_loc ** 2, dim=-1, keepdim=True) - r ** 2)
    under_sqrt = torch.clamp(under_sqrt, min=0.0)
    sqrt = torch.sqrt(under_sqrt)
    sign = torch.tensor([-1.0, 1.0], dtype=sqrt.dtype, device=sqrt.device)
    both = sqrt * sign - ray_cam_dot
    return torch.clamp(both, min=0.0)


def load_K_Rt_from_P(P: np.ndarray):
    """Decompose a 3x4 projection P = K [R | t] into intrinsics (4, 4)
    and the camera-to-world pose (4, 4), float32 (host-side numpy).

    What cv2.decomposeProjectionMatrix gives the JAX package: K and R by
    an RQ decomposition of P[:, :3] with the signs fixed so diag(K) > 0,
    K scaled to K[2, 2] = 1, and the camera centre from the null space
    of P. A reflection (det P[:, :3] < 0) moves into K[2, 2] before the
    scaling, so R is always a proper rotation."""
    P = np.asarray(P, np.float64)
    K, R = scipy.linalg.rq(P[:, :3])
    signs = np.diag(np.sign(np.diag(K)))
    K, R = K @ signs, signs @ R
    if np.linalg.det(R) < 0:
        # A proper rotation, as cv2 returns: K[2, 2] takes the sign.
        K[:, 2] *= -1.0
        R[2] *= -1.0
    K = K / K[2, 2]
    centre = np.linalg.svd(P)[2][-1]

    intrinsics = np.eye(4, dtype=np.float32)
    intrinsics[:3, :3] = K
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = R.transpose()
    pose[:3, 3] = centre[:3] / centre[3]
    return intrinsics, pose
