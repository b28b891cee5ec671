"""Inputs made from the seed on the device: sphere scenes, the MVS
probability volumes a trained cascade would emit for them, and the
field's weights.

The scene and the volumes are torch copies of the repository's numpy
generators (`make_sphere_scene`, `gt_prob_volume`), run on the card in
float64 where those run in float64; the depth noise comes from a
torch.Generator on the card. The weights are VolSDF's geometric
initialisation, drawn in one normal draw a scene and sliced, under the
port's state-dict names.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import torch

from port_bench.arith import colour_shapes, sdf_shapes

SEED_MOD = 2 ** 63 - 1


def sub_seed(seed: int, *parts: int) -> int:
    """A seed for one stream of one run: the run's seed and the stream's
    place, mixed into 63 bits."""
    x = int(seed) % SEED_MOD
    for p in parts:
        x = (x * 1_000_003 + int(p) + 1) % SEED_MOD
    return x


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


# ------------------------------------------------------------------ scene

def _look_at(eye: torch.Tensor) -> torch.Tensor:
    """Camera-to-world (4, 4) at `eye` looking at the origin, y up, +z
    forward (OpenCV), in float32."""
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float32, device=eye.device)
    fwd = -eye / torch.linalg.norm(eye)
    right = torch.linalg.cross(fwd, up)
    right = right / torch.linalg.norm(right)
    down = torch.linalg.cross(fwd, right)
    c2w = torch.eye(4, dtype=torch.float32, device=eye.device)
    c2w[:3, 0], c2w[:3, 1], c2w[:3, 2], c2w[:3, 3] = right, down, fwd, eye
    return c2w


def _pixel_dirs(c2w, K, H: int, W: int):
    """Camera-frame and unit world directions of every pixel centre."""
    dev = c2w.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=torch.float32, device=dev),
                            torch.arange(W, dtype=torch.float32, device=dev),
                            indexing="ij")
    cam = torch.stack([(xs - K[0, 2]) / K[0, 0], (ys - K[1, 2]) / K[1, 1],
                       torch.ones_like(xs)], dim=-1)
    dirs = cam @ c2w[:3, :3].T
    return cam, dirs / torch.linalg.norm(dirs, dim=-1, keepdim=True)


def _sphere_depth(origins, dirs, radius: float):
    b = torch.sum(origins * dirs, dim=-1)
    c = torch.sum(origins * origins, dim=-1) - radius ** 2
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where((disc >= 0) & (t > 0), t, torch.full_like(t, math.inf))


def view_angles(n_views: int) -> List[float]:
    """The training cameras' angles on their arc (radians)."""
    return [2 * math.pi * v / max(n_views, 1) * 0.25 for v in range(n_views)]


def sphere_scene(img_res: Sequence[int], sphere_radius: float, device,
                 angles: Sequence[float], cam_radius: float = 2.2,
                 light=(0.3, -0.5, -0.8)) -> Dict:
    """A diffuse sphere at the origin seen by pinhole cameras at `angles`
    on an arc: K, poses (V, 4, 4), images (V, H, W, 3), z-depths
    (V, H, W) (inf where a ray misses), on `device`."""
    H, W = img_res
    f = 0.9 * max(H, W)
    K = torch.eye(4, dtype=torch.float32, device=device)
    K[0, 0] = K[1, 1] = f
    K[0, 2], K[1, 2] = W / 2.0, H / 2.0
    ld = torch.tensor(light, dtype=torch.float32, device=device)
    ld = ld / torch.linalg.norm(ld)
    base = torch.tensor([0.85, 0.45, 0.3], dtype=torch.float32, device=device)
    miss = torch.tensor([0.05, 0.05, 0.08], dtype=torch.float32, device=device)
    poses, images, depths = [], [], []
    for ang in angles:
        eye = torch.tensor([cam_radius * math.sin(ang), 0.35 * cam_radius,
                            -cam_radius * math.cos(ang)], dtype=torch.float32,
                           device=device)
        c2w = _look_at(eye)
        cam, dirs = _pixel_dirs(c2w, K, H, W)
        origins = c2w[:3, 3].expand_as(dirs)
        t = _sphere_depth(origins, dirs, sphere_radius)
        hit = torch.isfinite(t)
        pts = origins + torch.where(hit, t, torch.zeros_like(t))[..., None] * dirs
        normal = pts / torch.clamp(torch.linalg.norm(pts, dim=-1, keepdim=True),
                                   min=1e-8)
        lam = torch.clamp(-torch.sum(normal * ld, dim=-1), 0.0, 1.0)
        img = torch.where(hit[..., None], (0.15 + 0.85 * lam[..., None]) * base,
                          miss)
        unit_z = (cam / torch.linalg.norm(cam, dim=-1, keepdim=True))[..., 2]
        depths.append(torch.where(hit, t * unit_z, torch.full_like(t, math.inf)))
        poses.append(c2w)
        images.append(img)
    V = len(angles)
    return {"K": K[None].expand(V, 4, 4).contiguous(),
            "poses": torch.stack(poses), "images": torch.stack(images),
            "depths": torch.stack(depths), "img_res": (H, W),
            "sphere_radius": sphere_radius}


def prob_volume(c2w, K, res, dvals: torch.Tensor, sphere_radius: float,
                sigma_intervals: float, floor: float, depth_noise: float,
                gen: Optional[torch.Generator]) -> torch.Tensor:
    """The probability volume (D, H, W) float32 a trained cascade would
    emit for the sphere: a Gaussian bump a pixel at its ground-truth
    z-depth (plus N(0, depth_noise) noise) over the hypotheses, mixed
    with a uniform floor; uniform where the ray misses."""
    H, W = res
    cam, dirs = _pixel_dirs(c2w, K, H, W)
    t = _sphere_depth(c2w[:3, 3].expand_as(dirs), dirs, sphere_radius)
    hit = torch.isfinite(t)
    unit_z = (cam / torch.linalg.norm(cam, dim=-1, keepdim=True))[..., 2]
    z = torch.where(hit, t * unit_z, torch.zeros_like(t)).double()
    if depth_noise > 0.0:
        z = z + depth_noise * torch.randn(z.shape, generator=gen,
                                          dtype=torch.float64, device=z.device)
    d = dvals.double()
    sigma = sigma_intervals * max(float(torch.median(torch.abs(torch.diff(d)))),
                                  1e-6)
    prob = torch.exp(-0.5 * ((d[:, None, None] - z[None]) / sigma) ** 2)
    prob = torch.where(hit[None], prob, torch.ones_like(prob))
    prob = prob / torch.clamp(prob.sum(dim=0, keepdim=True), min=1e-12)
    return ((1.0 - floor) * prob + floor / len(d)).float()


def volumes(scene: Dict, vol: Dict, gen: torch.Generator) -> Dict:
    """Every view's volume at vol["shape"] = (D, Hc, Wc) over hypotheses
    linspace(depth_range) in float32, with its near/far planes, its
    cameras at the volume's resolution and the image size: the plain
    dict the reference reads."""
    D, Hc, Wc = vol["shape"]
    H, W = scene["img_res"]
    dev = scene["poses"].device
    dvals = torch.linspace(vol["depth_range"][0], vol["depth_range"][1], D,
                           dtype=torch.float32, device=dev)
    probs = []
    for v in range(scene["poses"].shape[0]):
        Kc = scene["K"][v].clone()
        Kc[0, :] *= Wc / W
        Kc[1, :] *= Hc / H
        probs.append(prob_volume(scene["poses"][v], Kc, (Hc, Wc), dvals,
                                 scene["sphere_radius"], vol["sigma_intervals"],
                                 vol["floor"], vol["depth_noise"], gen))
    V = len(probs)
    slab = torch.stack([torch.full((V, Hc, Wc), float(dvals[0]), device=dev),
                        torch.full((V, Hc, Wc), float(dvals[-1]), device=dev)],
                       dim=1)
    return {"prob": torch.stack(probs), "z_slab": slab, "K": scene["K"],
            "c2w": scene["poses"], "img_res": scene["img_res"]}


# ------------------------------------------------------------------ weights

def _sdf_layers(imp: Dict, feature_size: int):
    """(in, out, kind, encoding width) of each SDF MLP layer under
    VolSDF's geometric initialisation (`arith.sdf_shapes`)."""
    shapes = sdf_shapes(imp, feature_size)
    d_pe = shapes[0][0]
    n = len(shapes)
    out = []
    for l, (i, o) in enumerate(shapes):
        if imp["geometric_init"] and l == n - 1:
            kind = "last"
        elif imp["geometric_init"] and imp["multires"] > 0 and l == 0:
            kind = "first"
        elif imp["geometric_init"] and imp["multires"] > 0 and l in imp["skip_in"]:
            kind = "skip"
        else:
            kind = "plain"
        out.append((i, o, kind, d_pe))
    return out


def init_weights(model: Dict, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """The field's weights from `gen`: the SDF MLP at VolSDF's geometric
    init (a sphere of radius `bias`), the radiance MLP at N(0, 2/out),
    beta at beta_init, and with a background its two plain MLPs; one
    normal draw for all of them, on the device."""
    specs = []   # (name, in, out, kind, extra)
    imp = model["implicit"]
    for l, (i, o, kind, d_pe) in enumerate(_sdf_layers(
            imp, model["feature_vector_size"])):
        specs.append(("sdf", l, i, o, kind, d_pe, imp))
    ren = model["rendering"]
    for l, (i, o) in enumerate(colour_shapes(ren, model["feature_vector_size"])):
        specs.append(("rgb", l, i, o, "plain", 0, ren))
    if model["with_background"]:
        bg = model["bg"]
        for l, (i, o, kind, d_pe) in enumerate(_sdf_layers(
                bg["implicit"], bg["feature_vector_size"])):
            specs.append(("bg_sdf", l, i, o, kind, d_pe, bg["implicit"]))
        bren = bg["rendering"]
        for l, (i, o) in enumerate(colour_shapes(bren, bg["feature_vector_size"])):
            specs.append(("bg_rgb", l, i, o, "plain", 0, bren))
    n_rgb = sum(1 for s in specs if s[0] == "rgb")
    total = sum(i * o for _, _, i, o, _, _, _ in specs)
    noise = torch.randn(total, generator=gen, dtype=torch.float32, device=device)
    P: Dict[str, torch.Tensor] = {}
    at = 0
    for net, l, i, o, kind, d_pe, part in specs:
        n01 = noise[at:at + i * o].reshape(i, o)
        at += i * o
        std = math.sqrt(2.0) / math.sqrt(o)
        b = torch.zeros(o, dtype=torch.float32, device=device)
        if kind == "last":
            w = math.sqrt(math.pi) / math.sqrt(i) + 1e-4 * n01
            b = torch.full((o,), -part["bias"], dtype=torch.float32, device=device)
        elif kind == "first":
            w = torch.zeros((i, o), dtype=torch.float32, device=device)
            w[:3] = std * n01[:3]
        elif kind == "skip":
            w = std * n01
            w[-(d_pe - 3):] = 0.0
        else:
            w = std * n01
        name = f"{net}.{l}"
        if part["weight_norm"]:
            P[f"{name}.v"] = w.contiguous()
            P[f"{name}.g"] = torch.linalg.norm(w, dim=0)
        else:
            P[f"{name}.w"] = w.contiguous()
        P[f"{name}.b"] = b
        if net == "rgb" and l == n_rgb - 1:
            P["density.beta"] = torch.tensor(model["density"]["beta_init"],
                                             dtype=torch.float32, device=device)
    return P
