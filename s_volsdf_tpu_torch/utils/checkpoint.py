"""Checkpoints in the JAX package's npz format (counterpart of
s_volsdf_tpu/utils/checkpoint.py:42-85): a checkpoint is a directory
with `state.npz`, one `leaf_<i>` array per leaf of the pytree in JAX's
flatten order, and `meta.json` (epoch and the like). Either package
loads the other's checkpoints.

The port has no pytree, so it keeps the order itself:

- `param_leaves`: the VolSDF parameters in the order
  `jax.tree_util.tree_flatten` gives the JAX parameter dict (keys
  sorted: density, rgb, sdf, after bg_rgb and bg_sdf for a background
  model; layers in order; each layer's leaves sorted: b, g, v or b, w);
- `train_state_leaves`: the JAX `TrainState` (params, opt_state,
  iter_step) with the optax chain clip + adam: the params, Adam's
  `count`, its `mu` and its `nu` in the params' order, then `iter_step`
  (the clip's and the LR scale's `EmptyState`s have no leaves).
  torch.optim.Adam's `step`, `exp_avg` and `exp_avg_sq` are `count`,
  `mu` and `nu`; `count` and `iter_step` are int32, as in JAX.

Arrays that JAX does not read (the torch generator's state) go into
`state.npz` under other keys (`extras`): the JAX loader reads only
`leaf_<i>`. The orbax backend is not ported (the card's machine has no
orbax): asking for it raises.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

STATE_FILE = "state.npz"
META_FILE = "meta.json"


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _check_backend(backend: str) -> None:
    if backend == "orbax":
        raise NotImplementedError("checkpoint backend 'orbax' is not ported "
                                  "(the card's machine has no orbax): use "
                                  "'npz'")
    if backend != "npz":
        raise ValueError(f"unknown ckpt backend {backend!r} "
                         "(expected 'npz' or 'orbax')")


def save_state(path: str, leaves: Sequence, *, backend: str = "npz",
               extras: Optional[Dict[str, np.ndarray]] = None,
               **meta) -> None:
    """Write `leaves` (tensors or arrays, in JAX's flatten order) as
    path/state.npz `leaf_<i>`, `extras` beside them under their own
    keys, and `meta` as path/meta.json."""
    _check_backend(backend)
    arrays = {f"leaf_{i}": _np(x) for i, x in enumerate(leaves)}
    for k, v in (extras or {}).items():
        if k.startswith("leaf_"):
            raise ValueError(f"extra array {k!r} would shadow a leaf")
        arrays[k] = _np(v)
    os.makedirs(path, exist_ok=True)
    np.savez(os.path.join(path, STATE_FILE), **arrays)
    with open(os.path.join(path, META_FILE), "w") as f:
        json.dump(meta, f)


def load_state(path: str, template: Sequence
               ) -> Tuple[List[np.ndarray], Dict[str, np.ndarray], Dict]:
    """(leaves, extras, meta) of the checkpoint at `path`; the leaves
    must have the shapes of `template`'s (a shape mismatch raises, as in
    JAX). A directory without state.npz raises (the JAX loader would take
    it for orbax)."""
    npz_path = os.path.join(path, STATE_FILE)
    if not os.path.exists(npz_path):
        if os.path.isdir(os.path.join(path, "orbax")):
            _check_backend("orbax")
        raise FileNotFoundError(f"no {STATE_FILE} under {path}")
    with np.load(npz_path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(template))]
        extras = {k: data[k] for k in data.files if not k.startswith("leaf_")}
    for old, new in zip(template, leaves):
        if tuple(np.shape(old)) != tuple(np.shape(new)):
            raise ValueError(f"checkpoint shape mismatch: {np.shape(new)} "
                             f"vs {tuple(np.shape(old))}")
    meta = {}
    meta_path = os.path.join(path, META_FILE)
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    return leaves, extras, meta


# --------------------------------------------------------------------------
# The VolSDF training state in JAX's leaf order
# --------------------------------------------------------------------------

def param_leaves(params) -> List[torch.nn.Parameter]:
    """The parameters of a `VolSDFParams` in JAX's flatten order of
    {"density": {"beta"}, "rgb": [...], "sdf": [...]}; of a
    `VolSDFBGParams`, of {"bg_rgb", "bg_sdf", "density", "rgb", "sdf"}."""
    bg = [params.bg_rgb, params.bg_sdf] if hasattr(params, "bg_sdf") else []
    return ([p for mlp in bg for p in _layer_leaves(mlp)]
            + [params.density.beta]
            + [p for mlp in (params.rgb, params.sdf)
               for p in _layer_leaves(mlp)])


def _layer_leaves(mlp) -> List[torch.nn.Parameter]:
    out = []
    for layer in mlp:
        named = dict(layer.named_parameters())
        out += [named[k] for k in sorted(named)]
    return out


def train_state_leaves(state) -> List[np.ndarray]:
    """The host arrays of an `engine.train_step.TrainState` in the order
    of the JAX TrainState's leaves."""
    params = param_leaves(state.params)
    adam = state.opt_state.adam
    count, mu, nu = 0, [], []
    for p in params:
        st = adam.state.get(p, {})
        if st:
            count = int(st["step"])
            mu.append(_np(st["exp_avg"]))
            nu.append(_np(st["exp_avg_sq"]))
        else:
            mu.append(np.zeros(tuple(p.shape), np.float32))
            nu.append(np.zeros(tuple(p.shape), np.float32))
    return ([_np(p) for p in params] + [np.asarray(count, np.int32)]
            + mu + nu + [np.asarray(state.iter_step, np.int32)])


def restore_train_state(state, leaves: Sequence[np.ndarray]) -> None:
    """Set a TrainState, in place, from leaves in `train_state_leaves`'
    order: the parameters, Adam's step and moments (an Adam state with
    step 0 is left empty, as a fresh optimiser has it) and iter_step."""
    params = param_leaves(state.params)
    n = len(params)
    if len(leaves) != 3 * n + 2:
        raise ValueError(f"{len(leaves)} leaves for a state of {3 * n + 2}")
    count = int(leaves[n])
    adam = state.opt_state.adam
    with torch.no_grad():
        for i, p in enumerate(params):
            p.copy_(torch.as_tensor(leaves[i]).to(p))
            adam.state.pop(p, None)
            if count:
                adam.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": torch.as_tensor(leaves[n + 1 + i]).to(p),
                    "exp_avg_sq": torch.as_tensor(leaves[2 * n + 1 + i]).to(p)}
    state.iter_step = int(leaves[-1])
