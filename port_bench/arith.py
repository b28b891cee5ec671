"""The benchmark's own arithmetic: the card's peaks, the percentile, the
union of device intervals, and the operations a step or a view needs,
counted from the configuration's widths and sample counts.

The counts are of the matrix products that the plain reference
(`reference/volsdf.py`) performs, 2 operations a multiply-add; the
elementwise work is left out. `tests/test_bench_arith.py` holds them to
torch's FlopCounterMode over the reference.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM data sheet, dense, without sparsity: the bf16 tensor
# cores' rate, the one peak every share is taken against, and HBM3's rate.
PEAK_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile by linear interpolation between the closest
    ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def merge_intervals(spans: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted ones."""
    out: List[List[float]] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    return sum(b - a for a, b in merge_intervals(spans))


# ------------------------------------------------------------------ widths

def sdf_shapes(imp: Dict, feature_size: int) -> List[Tuple[int, int]]:
    """(in, out) of each SDF MLP layer: the encoding's width in, the
    layer before a skip junction short by it, the last layer 1 +
    features wide."""
    d_pe = imp["d_in"] if imp["multires"] <= 0 else imp["d_in"] * (
        1 + 2 * imp["multires"])
    widths = [d_pe] + list(imp["dims"]) + [imp["d_out"] + feature_size]
    return [(widths[l], widths[l + 1] - (widths[0] if l + 1 in imp["skip_in"]
                                         else 0))
            for l in range(len(widths) - 1)]


def colour_shapes(ren: Dict, feature_size: int) -> List[Tuple[int, int]]:
    """(in, out) of each layer of a colour MLP: in 'idr' mode [points,
    encoded view, normal, features], in 'nerf' mode [encoded view,
    features]."""
    d_view = 3 if ren["multires_view"] <= 0 else 3 * (1 + 2 * ren["multires_view"])
    d_in = (ren["d_in"] + feature_size + d_view - 3 if ren["mode"] == "idr"
            else d_view + feature_size)
    widths = [d_in] + list(ren["dims"]) + [ren["d_out"]]
    return [(widths[l], widths[l + 1]) for l in range(len(widths) - 1)]


def macs(shapes: Sequence[Tuple[int, int]]) -> int:
    return sum(i * o for i, o in shapes)


def sdf_macs_col(model: Dict) -> int:
    """Multiply-adds of one point through the SDF MLP for its SDF alone
    (the last layer's first column): what a sweep needs. 459,008 at the
    dtu widths."""
    sh = sdf_shapes(model["implicit"], model["feature_vector_size"])
    return macs(sh[:-1]) + sh[-1][0]


def sdf_weight_count(model: Dict) -> int:
    sh = sdf_shapes(model["implicit"], model["feature_vector_size"])
    return macs(sh) + sum(o for _, o in sh)


# ------------------------------------------------------------------ counts

def final_samples(model: Dict) -> int:
    """Samples a ray takes through the gradient-carrying render: the
    final draws, the extra columns, near and far; with a background the
    last (the sphere's exit) bounds the foreground and is not rendered."""
    s = model["sampler"]
    n = s["N_samples"] + s["N_samples_extra"] + 2
    return n - 1 if model["with_background"] else n


def train_step_flops(model: Dict, n_rays: int) -> float:
    """Operations of one scene's training step (fast=1, one sweep) on
    n_rays rays. A = the SDF MLP's multiply-adds a point, a0 its first
    layer's, aL its last layer's, C the colour MLP's.

      sweep, N_samples_eval points a ray, no gradient: 2 A_col;
      each final sample: the SDF forward 2A and its input gradient 2A
        (dense through the last layer), the colour forward 2C, the
        colour backward 4C (weights and inputs), the SDF backward
        through the forward 2A + 2(A - a0) (no input gradient for the
        encoding) and through the input gradient 4A - 2aL (the last
        layer's incoming gradient is a constant);
      each eikonal point (two a ray): the forward and input gradient
        4A, the backward through the input gradient 4A - 2aL and
        through the forward of every layer but the last, whose output
        the loss never reads: 2(A - aL) + 2(A - aL - a0);
      with a background, N_samples_inverse_sphere points a ray through
        its SDF MLP (B, b0 its first layer) and colour MLP (D): the
        forwards 2B + 2D and the backwards 2B + 2(B - b0) + 4D.
    """
    imp = model["implicit"]
    sh = sdf_shapes(imp, model["feature_vector_size"])
    A, a0, aL = macs(sh), sh[0][0] * sh[0][1], sh[-1][0] * sh[-1][1]
    C = macs(colour_shapes(model["rendering"], model["feature_vector_size"]))
    per_final = 12 * A - 2 * a0 - 2 * aL + 6 * C
    per_eik = 12 * A - 6 * aL - 2 * a0
    s = model["sampler"]
    per_ray = (2 * sdf_macs_col(model) * s["N_samples_eval"]
               + final_samples(model) * per_final + 2 * per_eik)
    if model["with_background"]:
        bg = model["bg"]
        bsh = sdf_shapes(bg["implicit"], bg["feature_vector_size"])
        B, b0 = macs(bsh), bsh[0][0] * bsh[0][1]
        D = macs(colour_shapes(bg["rendering"], bg["feature_vector_size"]))
        per_ray += s["N_samples_inverse_sphere"] * (
            2 * B + 2 * D + 2 * B + 2 * (B - b0) + 4 * D)
    return float(per_ray) * n_rays


def view_flops(model: Dict, n_rays: int) -> float:
    """Operations of an eval render of n_rays rays that the
    configuration fixes: the first sweep (N_samples_eval points a ray,
    2 A_col each) and each final sample's SDF forward and input
    gradient (4A) and colour forward (2C). The sampler's later sweeps
    depend on the field and are left out."""
    sh = sdf_shapes(model["implicit"], model["feature_vector_size"])
    C = macs(colour_shapes(model["rendering"], model["feature_vector_size"]))
    s = model["sampler"]
    per_ray = (2 * sdf_macs_col(model) * s["N_samples_eval"]
               + final_samples(model) * (4 * macs(sh) + 2 * C))
    if model["with_background"]:
        bg = model["bg"]
        B = macs(sdf_shapes(bg["implicit"], bg["feature_vector_size"]))
        D = macs(colour_shapes(bg["rendering"], bg["feature_vector_size"]))
        per_ray += s["N_samples_inverse_sphere"] * (2 * B + 2 * D)
    return float(per_ray) * n_rays


def fused_sdf_least_seconds(model: Dict, points: int, launches: int) -> float:
    """The least time the card needs for `points` sweep points in
    `launches` launches of the SDF sweep: the larger of its operations
    (2 A_col a point) at the bf16 peak and its bytes (each point's 12
    bytes in and 4 out, and each launch's weights once, 2 bytes each,
    the fewest any mode reads) at HBM's rate. The same count whatever
    mode or implementation runs it."""
    ops = 2.0 * sdf_macs_col(model) * points
    nbytes = 16.0 * points + 2.0 * sdf_weight_count(model) * launches
    return max(ops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
