"""Whether what the timed path produced is correct: the plain reference
(`reference/`) recomputes it from the inputs the benchmark made, after
the program is freed, and each number compared is held to its limit
(`limits/<workload>.json`).

Training: the reference follows each scene's first steps on the same
weights, scene, volumes and draws (its own copy of the step's draws from
a generator seeded as the program's), and three numbers are compared,
each the worst over scenes: the first step's loss (relative gap), the
first step's clipped gradient by leaf and the parameters' change over
the steps by leaf (the gap of the two norms against the larger of the
reference's norm of that leaf and of the median leaf). Leaves whose
reference gradient is under a thousandth of the median leaf's move by
round-off alone under Adam and are left out of the change. The later
steps' losses are not compared: after Adam's first, nearly sign-like
step, elements whose gradient is near zero move by a full learning rate
either way on either side, and the loss's confidence gates turn on
that, so the two sides' second and third losses part by up to 3% on
sound runs (PERF.md). For the same reason the change is compared by its
median leaf: on the anneal's steps the colour term counts only rays of
no MVS confidence (under 1e-8), and whether a ray falls under that gate
turns on the last bits, so a leaf that only that term moves (the colour
MLP, the SDF's feature columns) moves on one side and not the other on
some seeds (PERF.md); the worst leaf's gap is reported beside it.

The tail step (entries/train.py): the last step of a call of
`tail_steps` steps made after the window, past the colour anneal, which
the reference follows for one step from the program's state before it
(its parameters, Adam's moments and counts, its generator). Its loss
and its colour term, its clipped gradient (from Adam's first moment
before and after it) by the median leaf and by the median of the colour
MLP's leaves, and its change by the median leaf are compared, as above:
each leaf's gap against the larger of its own norm and the median leaf's
of the whole model, so that a colour MLP whose gradient has all but
vanished (its sigmoid saturated, as on the post-anneal colour plateau)
reads its gaps of rounding as nought, not against its own near-zero
median.

Render: chunks of the window's views, drawn from the seed, are rendered
again by the reference, chunk for chunk (the sampler's early exit is a
chunk's), and rgb, depth, normal and acc are compared pixel by pixel.
"""

from __future__ import annotations

import math
import statistics
from typing import Dict, List, Optional

import torch

from port_bench.inputs import generator, sub_seed
from port_bench.reference import volsdf as ref

MOVED = 1e-3     # a leaf moves when its gradient is this share of the median's


def _worse(a: float, b: float) -> float:
    """The larger of two readings; a NaN reads as infinite."""
    return float("inf") if math.isnan(a) or math.isnan(b) else max(a, b)


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.norm(v.double())) for k, v in d.items()}


def _leaf_gaps(got: Dict[str, float], want: Dict[str, float], keys) -> List[float]:
    """Each leaf's gap of the two norms against the larger of the
    reference's norm of that leaf and of the median leaf."""
    keys = list(keys)
    med = statistics.median(want[k] for k in keys)
    return [abs(got[k] - want[k]) / max(want[k], med, 1e-30) for k in keys]


def lower_prec(prec: ref.Prec) -> ref.Prec:
    """The next lower precision than a stated bf16 training render's:
    fp8 (e4m3) products."""
    if prec.quant is None:
        raise NotImplementedError("a float32 training render's control is "
                                  "TF32; no cell states one yet")
    return ref.Prec(ref.fp8, prec.act)


def reference_training(entry, prec: ref.Prec, loss_mean=None) -> List[Dict]:
    """The reference's first steps of every scene of a TrainEntry, at
    `prec`."""
    out = []
    n = entry.traffic["checked_steps"]
    with ref.tf32(False):
        for s in range(entry.S):
            out.append(ref.train_steps(
                entry.weights[s], entry.cfg_doc, entry.scenes[s], entry.vols[s],
                generator(entry.draw_seeds[s], entry.device), n, prec,
                loss_mean=loss_mean))
    return out


def program_training(entry) -> List[Dict]:
    """What the program's first steps left, in the reference's terms."""
    return [{"losses": entry.losses[s],
             "first_grad": entry.first_grad[s], "params": entry.params_after[s]}
            for s in range(entry.S)]


def training_numbers(entry, got: List[Dict], want: List[Dict]) -> Dict[str, float]:
    """loss1_rel, grad_leaf, grad_median, change_leaf and change_median
    of `got` against `want`: each the worst scene's."""
    loss_rel = grad_leaf = grad_median = change_leaf = change_median = 0.0
    for s, (g, w) in enumerate(zip(got, want)):
        a, b = g["losses"][0]["loss"], w["losses"][0]["loss"]
        loss_rel = _worse(loss_rel, abs(a - b) / max(abs(b), 1e-30))
        gw = _norms(w["first_grad"])
        gaps = _leaf_gaps(_norms(g["first_grad"]), gw, gw)
        grad_leaf = _worse(grad_leaf, max(gaps))
        grad_median = _worse(grad_median, statistics.median(gaps))
        med = statistics.median(gw.values())
        moved = [k for k in gw if gw[k] >= MOVED * med]
        P0 = entry.weights[s]
        dg = _norms({k: g["params"][k] - P0[k] for k in moved})
        dw = _norms({k: w["params"][k] - P0[k] for k in moved})
        gaps = _leaf_gaps(dg, dw, moved)
        change_leaf = _worse(change_leaf, max(gaps))
        change_median = _worse(change_median, statistics.median(gaps))
    return {"loss1_rel": loss_rel, "grad_leaf": grad_leaf,
            "grad_median": grad_median, "change_leaf": change_leaf,
            "change_median": change_median}


def reference_tail(entry, prec: ref.Prec) -> List[Dict]:
    """The reference's one step of every scene from the program's state
    before the tail step, at `prec`."""
    out = []
    with ref.tf32(False):
        for s in range(entry.S):
            y = entry.tail_start[s]
            gen = torch.Generator(device=entry.device)
            gen.set_state(y["gen"])
            out.append(ref.train_steps(
                y["params"], entry.cfg_doc, entry.scenes[s], entry.vols[s], gen,
                1, prec, start=y["iter_step"], opt_state=y["adam"]))
    return out


def program_tail(entry) -> List[Dict]:
    """The program's tail step in the reference's terms: its loss, its
    clipped gradient g = (m_after - b1 m_before) / (1 - b1), and the
    parameters after it."""
    out = []
    for s in range(entry.S):
        y, z = entry.tail_start[s], entry.tail_end[s]
        grad = {k: (z["adam"][k][0] - 0.9 * y["adam"][k][0]) / (1 - 0.9)
                if k in z["adam"] and k in y["adam"] else
                torch.zeros_like(z["params"][k]) for k in z["params"]}
        out.append({"losses": [entry.tail_losses[s]], "first_grad": grad,
                    "params": z["params"], "replay": entry.tail_replay[s]})
    return out


def tail_numbers(entry, got: List[Dict], want: List[Dict]) -> Dict[str, float]:
    """tail_loss_rel, tail_rgb_loss_rel (the colour term's relative gap),
    tail_grad_median, tail_grad_leaf, rgb_grad_median,
    tail_change_median, tail_change_leaf and tail_replay (the relative
    gap of the two calls' common step's loss: 0 for a deterministic
    program) of `got` against `want`: each the worst scene's."""
    out = dict.fromkeys(("tail_loss_rel", "tail_rgb_loss_rel", "tail_grad_median",
                         "tail_grad_leaf", "rgb_grad_median", "tail_change_median",
                         "tail_change_leaf", "tail_replay"), 0.0)

    def worst(k, v):
        out[k] = _worse(out[k], v)

    for s, (g, w) in enumerate(zip(got, want)):
        for term, name in (("loss", "tail_loss_rel"), ("rgb_loss", "tail_rgb_loss_rel")):
            a, b = g["losses"][0][term], w["losses"][0][term]
            worst(name, abs(a - b) / max(abs(b), 1e-30))
        gw, gg = _norms(w["first_grad"]), _norms(g["first_grad"])
        gaps = dict(zip(gw, _leaf_gaps(gg, gw, gw)))
        worst("tail_grad_median", statistics.median(gaps.values()))
        worst("tail_grad_leaf", max(gaps.values()))
        colour = [k for k in gw if k.startswith("rgb.")]
        if colour:
            worst("rgb_grad_median", statistics.median(gaps[k] for k in colour))
        med = statistics.median(gw.values())
        moved = [k for k in gw if gw[k] >= MOVED * med]
        P0 = entry.tail_start[s]["params"]
        gaps = _leaf_gaps(_norms({k: g["params"][k] - P0[k] for k in moved}),
                          _norms({k: w["params"][k] - P0[k] for k in moved}), moved)
        worst("tail_change_median", statistics.median(gaps))
        worst("tail_change_leaf", max(gaps))
        worst("tail_replay", g["replay"])
    return out


def sample_chunks(entry) -> List[tuple]:
    """(view index in the window, chunk index) pairs drawn from the seed,
    distinct, as many as the traffic checks."""
    H, W = entry.scene_doc["img_res"]
    n_chunks = -(-H * W // entry.chunk)
    total = len(entry.views) * n_chunks
    k = min(entry.traffic["check_chunks"], total)
    gen = torch.Generator().manual_seed(sub_seed(entry.seed, 9))
    picks = torch.randperm(total, generator=gen)[:k].tolist()
    return [(p // n_chunks, p % n_chunks) for p in sorted(picks)]


def reference_render(entry, chunks, prec: ref.Prec, tf32: bool) -> List[Dict]:
    """The reference's render of each sampled chunk."""
    H, W = entry.scene_doc["img_res"]
    n_iters = (entry.traffic["fast"] if entry.traffic["fast"] >= 0
               else entry.cfg_doc["model"]["sampler"]["max_total_iters"])
    out = []
    with ref.tf32(tf32):
        for vi, c in chunks:
            v = entry.views[vi][0]
            idx = torch.arange(c * entry.chunk, min((c + 1) * entry.chunk, H * W),
                               device=entry.device)
            uv = torch.stack([(idx % W).float(),
                              torch.div(idx, W, rounding_mode="floor").float()], -1)
            o = ref.render_pixels(entry.weights, entry.cfg_doc["model"],
                                  entry.poses[v], entry.K[v], uv, prec, n_iters)
            out.append({k: t.detach().cpu() for k, t in o.items()})
    return out


def program_render(entry, chunks) -> List[Dict]:
    """The program's pixels of each sampled chunk, as (N, C) tensors."""
    H, W = entry.scene_doc["img_res"]
    out = []
    for vi, c in chunks:
        maps = entry.views[vi][1]
        a, b = c * entry.chunk, min((c + 1) * entry.chunk, H * W)
        out.append({k: torch.as_tensor(maps[k]).reshape(H * W, -1)[a:b]
                    .squeeze(-1) for k in ("rgb", "depth", "normal", "acc")})
    return out


def render_numbers(got: List[Dict], want: List[Dict]) -> Dict[str, float]:
    """Per map, the largest and the mean absolute gap over the pixels of
    the sampled chunks (a non-finite gap counts as infinite)."""
    out = {}
    for k in ("rgb", "depth", "normal", "acc"):
        d = torch.cat([(g[k].float() - w[k].float()).abs().reshape(-1)
                       for g, w in zip(got, want)])
        d = torch.where(torch.isfinite(d), d, torch.full_like(d, float("inf")))
        out[f"{k}_max"] = float(d.max())
        out[f"{k}_mean"] = float(d.mean())
    return out


def verdict(numbers: Dict[str, float], limits: Optional[Dict[str, float]]):
    """(correct, {name: {"value", "limit"}}): the numbers compared, each
    with its limit, then those only reported, with the limit None. A
    cell without limits is not correct."""
    limits = limits or {}
    shown = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    shown.update({k: {"value": v, "limit": None} for k, v in numbers.items()
                  if k not in limits})
    return bool(limits) and all(numbers[k] <= lim for k, lim in limits.items()), shown
