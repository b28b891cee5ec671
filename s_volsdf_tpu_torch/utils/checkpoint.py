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

A JAX TrainState may also come as one npz (`read_named_state`): its
leaves as `leaf_<i>` in that order and `names`, each leaf's key path
("params/sdf/0/v", "opt_state/1/0/mu/rgb/3/b", "opt_state/1/0/count",
"iter_step"), by which every leaf is carried.

A tree of dicts and lists of arrays (a converted checkpoint's, the
LPIPS weights) takes that order from `leaf_slots`; `read_tree` fills
one from a checkpoint.

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


def leaf_slots(tree, out: Optional[List] = None) -> List:
    """(container, key) of every leaf of a tree of dicts and lists, in
    `jax.tree_util.tree_flatten`'s order: dict keys sorted (as strings:
    "conv11" before "conv2"), lists in order."""
    out = [] if out is None else out
    items = sorted(tree.items()) if isinstance(tree, dict) \
        else enumerate(tree)
    for k, v in items:
        if isinstance(v, (dict, list)):
            leaf_slots(v, out)
        else:
            out.append((tree, k))
    return out


def tree_leaves(tree) -> List:
    """The leaves of a tree of dicts and lists in JAX's flatten order."""
    return [container[key] for container, key in leaf_slots(tree)]


def read_tree(path: str, tree) -> Dict:
    """Set the leaves of `tree` (dicts and lists), in place, from the
    checkpoint at `path`; returns its meta. The checkpoint must hold as
    many leaves as the tree, each of its leaf's shape."""
    slots = leaf_slots(tree)
    with np.load(os.path.join(path, STATE_FILE)) as data:
        n = sum(k.startswith("leaf_") for k in data.files)
    if n != len(slots):
        raise ValueError(f"{path}: {n} leaves, the tree has {len(slots)}")
    leaves, _, meta = load_state(path, [c[k] for c, k in slots])
    for (container, key), leaf in zip(slots, leaves):
        container[key] = leaf
    return meta


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


def jax_state_slot(name: str) -> Tuple[str, str]:
    """The port's slot of a JAX TrainState leaf named by its key path:
    ("param" | "mu" | "nu", the port's parameter name) or ("count" |
    "iter_step", "")."""
    parts = name.split("/")
    if parts == ["iter_step"]:
        return ("iter_step", "")
    if parts[0] == "params":
        return ("param", ".".join(parts[1:]))
    if parts[0] == "opt_state":
        if parts[-1] == "count":
            return ("count", "")
        for moment in ("mu", "nu"):
            if moment in parts:
                return (moment, ".".join(parts[parts.index(moment) + 1:]))
    raise ValueError(f"{name!r} is no leaf of a TrainState of clip + adam")


def train_state_slots(params) -> List[Tuple[str, str]]:
    """The slots (`jax_state_slot`) of `train_state_leaves`, in order."""
    names = {id(p): n for n, p in params.named_parameters()}
    order = [names[id(p)] for p in param_leaves(params)]
    return ([("param", n) for n in order] + [("count", "")]
            + [("mu", n) for n in order] + [("nu", n) for n in order]
            + [("iter_step", "")])


def read_named_state(path: str, state) -> None:
    """Set a TrainState, in place, from an npz of a JAX TrainState
    (`leaf_<i>` and their key paths `names`): each of the state's
    slots from the leaf of its name, of its parameter's shape. The file
    must hold every slot once, and in `train_state_leaves`' order, so
    that the trainer's positional loader reads it alike."""
    with np.load(path) as data:
        names = [str(n) for n in data["names"]]
        leaves = [data[f"leaf_{i}"] for i in range(len(names))]
    slots = [jax_state_slot(n) for n in names]
    want = train_state_slots(state.params)
    if slots != want:
        missing = sorted(set(want) - set(slots))
        extra = sorted(set(slots) - set(want))
        raise ValueError(f"{path}: the leaves are not the state's in its "
                         f"order (missing {missing}, extra {extra})")
    params = dict(state.params.named_parameters())
    for (kind, name), leaf in zip(slots, leaves):
        if name and tuple(leaf.shape) != tuple(params[name].shape):
            raise ValueError(f"{path}: {kind} {name} {leaf.shape}, the "
                             f"parameter {tuple(params[name].shape)}")
    restore_train_state(state, leaves)
