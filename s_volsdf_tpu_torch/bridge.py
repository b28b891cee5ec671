"""Parameters between the JAX package and the port.

The JAX VolSDF parameters are the pytree
{"sdf": [{"v", "g", "b"} | {"w", "b"}, ...], "rgb": [...],
 "density": {"beta"}} (a BlendedMVS model adds "bg_sdf" and "bg_rgb");
the port's `VolSDFParams` (`VolSDFBGParams`) keeps the same leaves in
the same layouts ((in, out) weights), so the conversion is one to one
and exact.

The JAX MVS parameters (CasMVSNet and UCSNet {"feature": {...},
"cost_reg": [...]}; TransMVSNet also "fmt" and "pixelwise") hold each
conv as a {"w", "b"?, "bn"?: {"scale", "bias", "mean", "var"}} leaf dict
with HWIO / DHWIO kernels; the transposed convs' kernels are stored
flipped, for an input-dilated conv. `from_jax_mvs_params` and
`to_jax_mvs_params` transpose them to OIHW / OIDHW, flip the transposed
convs back into `ConvTranspose2d`'s / `ConvTranspose3d`'s (I, O, k...),
and map BN onto weight / bias / running_mean / running_var. A DCN is
{"offset_conv", "w" (9 Cin, Cout) tap-major, "b"}; the FMT's linears
{"w" (in, out), "b"} and LayerNorms {"scale", "bias"} are the port's
own parameter names. Both directions are exact, and a tree whose leaves
do not match the net raises. `load_mvs_checkpoint` reads a converted
checkpoint (`python -m s_volsdf_tpu_torch.tools.convert_ckpt` writes
one: `state.npz` of the pytree's leaves in JAX's flatten order,
`utils.checkpoint.leaf_slots`); `load_volsdf_checkpoint` reads a
converted VolSDF state dict.

The JAX LPIPS weights ({"features": [[{"b", "w"}]], "lins": [{"w"}]},
HWIO kernels) become `models.lpips.LPIPS` (OIHW) with `lpips_from_jax`.

Stacked trees (every leaf with a leading scene axis S, the JAX
package's `vmap`ped multi-scene state) convert the same way, to the
port's stacked parameters (`models.network.stack_params`);
`from_jax_stacked_state` and `to_jax_stacked_state` also carry the
optax Adam state (count (S,), mu, nu) to the port's `StackedOptimizer`
and back.

All functions take and give numpy arrays; none imports JAX.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
from torch import nn

from s_volsdf_tpu_torch.models.density import LaplaceDensity
from s_volsdf_tpu_torch.models.layers import Linear, WeightNormLinear
from s_volsdf_tpu_torch.models.lpips import LPIPS
from s_volsdf_tpu_torch.models.mvs import blocks as B
from s_volsdf_tpu_torch.models.mvs.blocks import ConvBnReLU
from s_volsdf_tpu_torch.models.mvs.casmvsnet import CasMVSNet
from s_volsdf_tpu_torch.models.mvs.fmt import Dense, LayerNorm
from s_volsdf_tpu_torch.models.mvs.transmvsnet import DCN, TransMVSNet
from s_volsdf_tpu_torch.models.mvs.ucsnet import UCSNet
from s_volsdf_tpu_torch.models.network import VolSDFParams, map_leaves
from s_volsdf_tpu_torch.models.network_bg import VolSDFBGParams
from s_volsdf_tpu_torch.utils import checkpoint as ckpt


def _tensor(a, device) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.float32, device=device)


def _mlp_from(layers_np: List[Dict], device) -> nn.ModuleList:
    mods = []
    for p in layers_np:
        if "v" in p:
            mods.append(WeightNormLinear(_tensor(p["v"], device),
                                         _tensor(p["g"], device),
                                         _tensor(p["b"], device)))
        else:
            mods.append(Linear(_tensor(p["w"], device),
                               _tensor(p["b"], device)))
    return nn.ModuleList(mods)


def from_jax_params(np_params: Dict, device=None) -> VolSDFParams:
    """JAX pytree of numpy arrays -> VolSDFParams, or VolSDFBGParams for
    a tree with the background MLPs ("bg_sdf", "bg_rgb")."""
    density = LaplaceDensity(device=device)
    density.beta = nn.Parameter(_tensor(np_params["density"]["beta"], device))
    fg = (_mlp_from(np_params["sdf"], device),
          _mlp_from(np_params["rgb"], device), density)
    if "bg_sdf" in np_params:
        return VolSDFBGParams(*fg, _mlp_from(np_params["bg_sdf"], device),
                              _mlp_from(np_params["bg_rgb"], device))
    return VolSDFParams(*fg)


def _mlp_to(mods: nn.ModuleList) -> List[Dict]:
    return [{name: p.detach().cpu().numpy().copy()
             for name, p in m.named_parameters()} for m in mods]


def to_jax_params(params: VolSDFParams) -> Dict:
    """VolSDFParams -> the JAX pytree, as numpy arrays."""
    tree = {
        "sdf": _mlp_to(params.sdf),
        "rgb": _mlp_to(params.rgb),
        "density": {"beta": params.density.beta.detach().cpu().numpy().copy()},
    }
    if isinstance(params, VolSDFBGParams):
        tree["bg_sdf"] = _mlp_to(params.bg_sdf)
        tree["bg_rgb"] = _mlp_to(params.bg_rgb)
    return tree


def _adam_state(opt_state):
    """The optax ScaleByAdamState (count, mu, nu) inside an optax state
    (adam alone, or chained after the clip)."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    if isinstance(opt_state, (tuple, list)):
        for part in opt_state:
            found = _adam_state(part)
            if found is not None:
                return found
    return None


def from_jax_stacked_state(state, cfg, device=None):
    """A JAX TrainState of S scenes (params, opt_state, iter_step with a
    leading scene axis, as numpy arrays: the state the JAX package's
    multi-scene loop vmaps over) -> the port's stacked TrainState: the
    stacked parameters, a StackedOptimizer holding each scene's Adam
    count and moments, and the common iter_step (scenes at different
    steps raise)."""
    from s_volsdf_tpu_torch.engine.train_step import (TrainState,
                                                      make_stacked_optimizer)
    params = from_jax_params(state.params, device)
    tx = make_stacked_optimizer(cfg, params)
    adam = _adam_state(state.opt_state)
    counts = np.asarray(adam.count).reshape(-1)
    with torch.no_grad():
        for l, (m, v) in enumerate(zip(
                from_jax_params(adam.mu, device).parameters(),
                from_jax_params(adam.nu, device).parameters())):
            tx.exp_avg[l].copy_(m)
            tx.exp_avg_sq[l].copy_(v)
            for s, c in enumerate(counts):
                tx.steps[s][l] = torch.tensor(float(c))
    steps = set(np.asarray(state.iter_step).reshape(-1).tolist())
    if len(steps) != 1:
        raise ValueError(f"from_jax_stacked_state: scenes at steps {steps}")
    return TrainState(params, tx, int(steps.pop()))


def to_jax_stacked_state(state) -> Dict:
    """The port's stacked TrainState -> {"params", "mu", "nu"} JAX trees,
    "count" (S,) int32 and "iter_step", as numpy arrays."""
    tx = state.opt_state

    def tree(leaves):
        with torch.no_grad():
            out = map_leaves(state.params, lambda name, p: leaves[name])
        return to_jax_params(out)

    names = [n for n, _ in state.params.named_parameters()]
    return {"params": to_jax_params(state.params),
            "mu": tree(dict(zip(names, tx.exp_avg))),
            "nu": tree(dict(zip(names, tx.exp_avg_sq))),
            "count": np.array([tx.count(s) for s in range(tx.S)], np.int32),
            "iter_step": np.int32(state.iter_step)}


# --------------------------------------------------------------------------
# The MVS nets
# --------------------------------------------------------------------------

_TORCH_NAME = {"cost_reg": "cost_regularization"}
_JAX_NAME = {v: k for k, v in _TORCH_NAME.items()}
_TRANSPOSED = (nn.ConvTranspose2d, nn.ConvTranspose3d)
_BN = (nn.BatchNorm2d, nn.BatchNorm3d)
_BN_FIELDS = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
              ("var", "running_var"))
# Modules whose parameters carry the JAX leaves' names and layouts.
_SAME_LEAVES = (Dense, LayerNorm)
_NETS = {"casmvsnet": CasMVSNet, "ucsnet": UCSNet,
         "transmvsnet": TransMVSNet}


def _kernel_from_jax(conv: nn.Module, w: np.ndarray) -> np.ndarray:
    if isinstance(conv, _TRANSPOSED):
        # Flipped HWIO / DHWIO -> (I, O, k...).
        sp = tuple(range(w.ndim - 2))
        return np.flip(w, sp).transpose((w.ndim - 2, w.ndim - 1) + sp)
    if w.ndim == 4:
        return w.transpose(3, 2, 0, 1)          # HWIO -> OIHW
    return w.transpose(4, 3, 0, 1, 2)           # DHWIO -> OIDHW


def _kernel_to_jax(conv: nn.Module, w: np.ndarray) -> np.ndarray:
    if isinstance(conv, _TRANSPOSED):
        sp = tuple(range(w.ndim - 2))
        return np.flip(w.transpose(tuple(i + 2 for i in sp) + (0, 1)), sp)
    if w.ndim == 4:
        return w.transpose(2, 3, 1, 0)
    return w.transpose(2, 3, 4, 1, 0)


def _split(mod: nn.Module):
    """(conv, bn or None) of a block or a plain conv."""
    if isinstance(mod, ConvBnReLU):
        return mod.conv, mod.bn
    return mod, None


def _copy(param: torch.Tensor, a, what: str) -> None:
    a = np.asarray(a, np.float32)
    if tuple(a.shape) != tuple(param.shape):
        raise ValueError(f"{what}: {a.shape} vs {tuple(param.shape)}")
    param.copy_(_tensor(a, param.device))


def _load_bn(bn: nn.Module, q: Dict) -> None:
    for jname, tname in _BN_FIELDS:
        _copy(getattr(bn, tname), q[jname], f"bn {jname}")


@torch.no_grad()
def load_conv(mod: nn.Module, p: Dict) -> None:
    """Load one JAX conv leaf {"w", "b"?, "bn"?} into a block or a plain
    conv, in place."""
    conv, bn = _split(mod)
    if ("b" in p) != (conv.bias is not None) or ("bn" in p) != (bn is not None):
        raise ValueError(f"conv leaf {sorted(p)} does not match {mod}")
    w = np.ascontiguousarray(
        _kernel_from_jax(conv, np.asarray(p["w"], np.float32)))
    _copy(conv.weight, w, "kernel")
    if "b" in p:
        _copy(conv.bias, p["b"], "conv bias")
    if "bn" in p:
        _load_bn(bn, p["bn"])


def _check_keys(tree: Dict, names, mod: nn.Module) -> None:
    if set(tree) != set(names):
        raise ValueError(f"leaves {sorted(tree)} do not match "
                         f"{type(mod).__name__}'s {sorted(names)}")


@torch.no_grad()
def _load_tree(mod: nn.Module, tree) -> None:
    if isinstance(mod, (ConvBnReLU,) + B.CONVS):
        load_conv(mod, tree)
    elif isinstance(mod, _BN):
        _check_keys(tree, [j for j, _ in _BN_FIELDS], mod)
        _load_bn(mod, tree)
    elif isinstance(mod, DCN):
        _check_keys(tree, ("offset_conv", "w", "b"), mod)
        load_conv(mod.offset_conv, tree["offset_conv"])
        _copy(mod.w, tree["w"], "DCN weight")
        _copy(mod.b, tree["b"], "DCN bias")
    elif isinstance(mod, _SAME_LEAVES):
        names = [n for n, _ in mod.named_parameters()]
        _check_keys(tree, names, mod)
        for n in names:
            _copy(getattr(mod, n), tree[n], f"{type(mod).__name__}.{n}")
    elif isinstance(tree, list):
        if len(tree) != len(mod):
            raise ValueError(f"{len(tree)} entries for {len(mod)} modules")
        for m, t in zip(mod, tree):
            _load_tree(m, t)
    else:
        _check_keys(tree, [_JAX_NAME.get(k, k) for k, _ in
                           mod.named_children()], mod)
        for k, t in tree.items():
            _load_tree(getattr(mod, _TORCH_NAME.get(k, k)), t)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy().copy()


def _conv_to(mod: nn.Module) -> Dict:
    conv, bn = _split(mod)
    p = {"w": np.ascontiguousarray(_kernel_to_jax(conv, _np(conv.weight)))}
    if conv.bias is not None:
        p["b"] = _np(conv.bias)
    if bn is not None:
        p["bn"] = _bn_to(bn)
    return p


def _bn_to(bn: nn.Module) -> Dict:
    return {j: _np(getattr(bn, t)) for j, t in _BN_FIELDS}


def _tree_to(mod: nn.Module):
    if isinstance(mod, (ConvBnReLU,) + B.CONVS):
        return _conv_to(mod)
    if isinstance(mod, _BN):
        return _bn_to(mod)
    if isinstance(mod, DCN):
        return {"offset_conv": _conv_to(mod.offset_conv), "w": _np(mod.w),
                "b": _np(mod.b)}
    if isinstance(mod, _SAME_LEAVES):
        return {n: _np(p) for n, p in mod.named_parameters()}
    if isinstance(mod, (nn.Sequential, nn.ModuleList)):
        return [_tree_to(m) for m in mod]
    return {_JAX_NAME.get(k, k): _tree_to(m) for k, m in mod.named_children()}


def from_jax_mvs_params(np_params: Dict, ndepths=(192, 32, 8),
                        cr_base_chs=(8, 8, 8), device=None,
                        model: str = "casmvsnet") -> nn.Module:
    """A JAX MVS pytree of numpy arrays (`init_casmvsnet`, `init_ucsnet`
    (`cr_base_chs` its `base_chs`) or `init_transmvsnet`, per `model`)
    -> the frozen port net."""
    base = np.asarray(np_params["feature"]["conv0"][0]["w"]).shape[-1]
    if model == "ucsnet":
        net = UCSNet(ndepths, cr_base_chs, base)
    else:
        net = _NETS[model](ndepths, base, cr_base_chs)
    net = net.to(device)
    _load_tree(net, np_params)
    return net.eval().requires_grad_(False)


def to_jax_mvs_params(net: nn.Module) -> Dict:
    """A port MVS net -> its JAX pytree, as numpy arrays."""
    return _tree_to(net)


def load_mvs_checkpoint(net: nn.Module, path: str) -> nn.Module:
    """Load a converted checkpoint directory (`state.npz` with leaves
    `leaf_<i>` in JAX's flatten order of the pytree) into `net`."""
    tree = to_jax_mvs_params(net)
    ckpt.read_tree(path, tree)
    _load_tree(net, tree)
    return net


def load_volsdf_checkpoint(path: str, template: VolSDFParams,
                           device=None) -> VolSDFParams:
    """The VolSDF parameters of a converted checkpoint directory (a
    reference state dict through `tools.convert_ckpt --model volsdf`),
    read in the leaf order and shapes of `template`'s JAX tree."""
    tree = to_jax_params(template)
    ckpt.read_tree(path, tree)
    return from_jax_params(tree, device)


# --------------------------------------------------------------------------
# LPIPS
# --------------------------------------------------------------------------

def lpips_from_jax(np_params: Dict, device=None) -> LPIPS:
    """The JAX LPIPS tree (numpy) -> LPIPS: HWIO kernels to OIHW."""
    convs = [c for block in np_params["features"] for c in block]
    return LPIPS(
        [nn.Parameter(_tensor(np.transpose(c["w"], (3, 2, 0, 1)), device))
         for c in convs],
        [nn.Parameter(_tensor(c["b"], device)) for c in convs],
        [nn.Parameter(_tensor(lin["w"], device))
         for lin in np_params["lins"]])
