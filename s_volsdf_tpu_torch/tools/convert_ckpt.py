"""Convert the reference's PyTorch checkpoints into the port's weights
(counterpart of tools/convert_ckpt.py, without JAX).

    python -m s_volsdf_tpu_torch.tools.convert_ckpt --model casmvsnet \\
        --ckpt data_s_volsdf/mvs_models/casmvsnet.ckpt \\
        --out data_s_volsdf/mvs_models/casmvsnet_jax

--model is one of casmvsnet (casmvsnet.ckpt), ucsnet (ucsnet.ckpt),
transmvsnet (model_dtu.ckpt), volsdf (a VolSDF network's state dict, at
the dtu widths: 9 SDF and 5 radiance layers, no background) or lpips
(the torch `lpips` package's VGG state dict). The file is read with
`torch.load(..., weights_only=True)`: a file that pickles objects other
than tensors and containers fails with torch's message. A dict with a
"model" entry (the reference's {"epoch", "model", "optimizer"}) gives
that entry, any other dict is the state dict itself.

--out D gets D/state.npz, the converted tree's leaves as `leaf_<i>` in
JAX's flatten order (`utils.checkpoint.tree_leaves`), and D/meta.json
{"model": ...}: the files tools/convert_ckpt.py writes. The JAX
package's `utils.checkpoint.load_state` and the port's
`MVSEngine(cfg, weights_path=D)`, `models.lpips.load_lpips(D)`,
`bridge.load_volsdf_checkpoint(D, ...)` and `cli.run ...
mvs_weights=D` read them.

`convert(model, state_dict, **kwargs)` returns the numpy tree the JAX
tool's `convert` returns (the volsdf converter's layer counts and
background layers are its keyword arguments). The layout transforms:

  Conv2d OIHW                    -> HWIO
  Conv3d OIDHW                   -> DHWIO
  ConvTranspose2d (I,O,kh,kw)    -> flipped HWIO (input-dilated equiv)
  ConvTranspose3d (I,O,kd,kh,kw) -> flipped DHWIO
  Linear (O,I)                   -> (I,O)
  DCN weight OIHW                -> (K*Cin, Cout) tap-major rows
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional

import numpy as np

from s_volsdf_tpu_torch.utils import checkpoint as ckpt


# --------------------------------------------------------------------------
# Layout transforms
# --------------------------------------------------------------------------

def conv2d_w(w):          # OIHW -> HWIO
    return np.transpose(w, (2, 3, 1, 0))


def conv3d_w(w):          # OIDHW -> DHWIO
    return np.transpose(w, (2, 3, 4, 1, 0))


def deconv2d_w(w):        # (I, O, kh, kw) -> flipped HWIO
    w = w[:, :, ::-1, ::-1]
    return np.transpose(w, (2, 3, 0, 1)).copy()


def deconv3d_w(w):        # (I, O, kd, kh, kw) -> flipped DHWIO
    w = w[:, :, ::-1, ::-1, ::-1]
    return np.transpose(w, (2, 3, 4, 0, 1)).copy()


def linear_w(w):          # (O, I) -> (I, O)
    return np.transpose(w, (1, 0))


def dcn_w(w):             # OIHW -> (K*Cin, Cout) tap-major
    cout, cin, kh, kw = w.shape
    return np.transpose(w, (2, 3, 1, 0)).reshape(kh * kw * cin, cout)


def _bn(sd: Dict, prefix: str) -> Dict:
    return {
        "scale": np.asarray(sd[f"{prefix}.weight"]),
        "bias": np.asarray(sd[f"{prefix}.bias"]),
        "mean": np.asarray(sd[f"{prefix}.running_mean"]),
        "var": np.asarray(sd[f"{prefix}.running_var"]),
    }


def _conv_block(sd: Dict, prefix: str, kind: str = "conv2d",
                bn: bool = True) -> Dict:
    """Reference Conv2d/Conv3d/Deconv block (conv + optional BN)."""
    fn = {"conv2d": conv2d_w, "conv3d": conv3d_w, "deconv2d": deconv2d_w,
          "deconv3d": deconv3d_w}[kind]
    out = {"w": fn(np.asarray(sd[f"{prefix}.conv.weight"]))}
    if f"{prefix}.conv.bias" in sd:
        out["b"] = np.asarray(sd[f"{prefix}.conv.bias"])
    if bn and f"{prefix}.bn.weight" in sd:
        out["bn"] = _bn(sd, f"{prefix}.bn")
    return out


def _plain_conv(sd: Dict, prefix: str, kind: str = "conv2d") -> Dict:
    fn = {"conv2d": conv2d_w, "conv3d": conv3d_w}[kind]
    out = {"w": fn(np.asarray(sd[f"{prefix}.weight"]))}
    if f"{prefix}.bias" in sd:
        out["b"] = np.asarray(sd[f"{prefix}.bias"])
    return out


# --------------------------------------------------------------------------
# CasMVSNet (reference models/CasMVSNet.py:338-703)
# --------------------------------------------------------------------------

def convert_casmvsnet(sd: Dict, n_stages: int = 3) -> Dict:
    f = "feature"
    feat = {
        "conv0": [_conv_block(sd, f"{f}.conv0.{i}") for i in range(2)],
        "conv1": [_conv_block(sd, f"{f}.conv1.{i}") for i in range(3)],
        "conv2": [_conv_block(sd, f"{f}.conv2.{i}") for i in range(3)],
        "out1": _plain_conv(sd, f"{f}.out1"),
        "inner1": _plain_conv(sd, f"{f}.inner1"),
        "inner2": _plain_conv(sd, f"{f}.inner2"),
        "out2": _plain_conv(sd, f"{f}.out2"),
        "out3": _plain_conv(sd, f"{f}.out3"),
    }
    cost_reg = []
    for s in range(n_stages):
        cr = f"cost_regularization.{s}"
        cost_reg.append({
            "conv0": _conv_block(sd, f"{cr}.conv0", "conv3d"),
            "conv1": _conv_block(sd, f"{cr}.conv1", "conv3d"),
            "conv2": _conv_block(sd, f"{cr}.conv2", "conv3d"),
            "conv3": _conv_block(sd, f"{cr}.conv3", "conv3d"),
            "conv4": _conv_block(sd, f"{cr}.conv4", "conv3d"),
            "conv5": _conv_block(sd, f"{cr}.conv5", "conv3d"),
            "conv6": _conv_block(sd, f"{cr}.conv6", "conv3d"),
            "conv7": _conv_block(sd, f"{cr}.conv7", "deconv3d"),
            "conv9": _conv_block(sd, f"{cr}.conv9", "deconv3d"),
            "conv11": _conv_block(sd, f"{cr}.conv11", "deconv3d"),
            "prob": _plain_conv(sd, f"{cr}.prob", "conv3d"),
        })
    return {"feature": feat, "cost_reg": cost_reg}


# --------------------------------------------------------------------------
# UCSNet (reference models/ucsnet.py:237-415)
# --------------------------------------------------------------------------

def convert_ucsnet(sd: Dict, n_stages: int = 3) -> Dict:
    f = "feature_extraction"
    feat = {
        "conv0": [_conv_block(sd, f"{f}.conv0.{i}") for i in range(2)],
        "conv1": [_conv_block(sd, f"{f}.conv1.{i}") for i in range(3)],
        "conv2": [_conv_block(sd, f"{f}.conv2.{i}") for i in range(3)],
        "out1": _plain_conv(sd, f"{f}.out1"),
        "deconv1": {
            "deconv": _conv_block(sd, f"{f}.deconv1.deconv", "deconv2d"),
            "conv": _conv_block(sd, f"{f}.deconv1.conv"),
        },
        "deconv2": {
            "deconv": _conv_block(sd, f"{f}.deconv2.deconv", "deconv2d"),
            "conv": _conv_block(sd, f"{f}.deconv2.conv"),
        },
        "out2": _plain_conv(sd, f"{f}.out2"),
        "out3": _plain_conv(sd, f"{f}.out3"),
    }
    cost_reg = []
    for s in range(n_stages):
        cr = f"cost_regularization.{s}"
        cost_reg.append({
            "conv0": _conv_block(sd, f"{cr}.conv0", "conv3d"),
            "conv1": _conv_block(sd, f"{cr}.conv1", "conv3d"),
            "conv2": _conv_block(sd, f"{cr}.conv2", "conv3d"),
            "conv3": _conv_block(sd, f"{cr}.conv3", "conv3d"),
            "conv4": _conv_block(sd, f"{cr}.conv4", "conv3d"),
            "conv5": _conv_block(sd, f"{cr}.conv5", "conv3d"),
            "conv6": _conv_block(sd, f"{cr}.conv6", "conv3d"),
            # ucsnet names its cost-reg deconvs deconv7/8/9
            # (ucsnet.py:318-322); they map onto our conv7/9/11 slots.
            "conv7": _conv_block(sd, f"{cr}.deconv7", "deconv3d"),
            "conv9": _conv_block(sd, f"{cr}.deconv8", "deconv3d"),
            "conv11": _conv_block(sd, f"{cr}.deconv9", "deconv3d"),
            "prob": _plain_conv(sd, f"{cr}.prob", "conv3d"),
        })
    return {"feature": feat, "cost_reg": cost_reg}


# --------------------------------------------------------------------------
# TransMVSNet (reference models/module.py:345-423, FMT.py, dcn.py)
# --------------------------------------------------------------------------

def _dcn(sd: Dict, prefix: str) -> Dict:
    w = np.asarray(sd[f"{prefix}.weight"])
    k = w.shape[2]
    out = {
        "offset_conv": {
            "w": conv2d_w(np.asarray(sd[f"{prefix}.conv_offset_mask.weight"])),
            "b": np.asarray(sd[f"{prefix}.conv_offset_mask.bias"]),
        },
        "w": dcn_w(w),
        "b": (np.asarray(sd[f"{prefix}.bias"])
              if f"{prefix}.bias" in sd else np.zeros(w.shape[0],
                                                      np.float32)),
    }
    return out


def _dcn_head(sd: Dict, prefix: str) -> Dict:
    """out1/out2/out3 sequential: [Conv2d, DCN, BN, ReLU, DCN, BN,
    ReLU, DCN] (module.py:364-397)."""
    return {
        "conv": _conv_block(sd, f"{prefix}.0"),
        "dcn1": _dcn(sd, f"{prefix}.1"),
        "bn1": _bn(sd, f"{prefix}.2"),
        "dcn2": _dcn(sd, f"{prefix}.4"),
        "bn2": _bn(sd, f"{prefix}.5"),
        "dcn3": _dcn(sd, f"{prefix}.7"),
    }


def _linear(sd: Dict, prefix: str) -> Dict:
    return {"w": linear_w(np.asarray(sd[f"{prefix}.weight"])),
            "b": np.asarray(sd[f"{prefix}.bias"])}


def _encoder_layer(sd: Dict, prefix: str) -> Dict:
    return {
        "q": _linear(sd, f"{prefix}.attention.query_projection"),
        "k": _linear(sd, f"{prefix}.attention.key_projection"),
        "v": _linear(sd, f"{prefix}.attention.value_projection"),
        "out": _linear(sd, f"{prefix}.attention.out_projection"),
        "ff1": _linear(sd, f"{prefix}.linear1"),
        "ff2": _linear(sd, f"{prefix}.linear2"),
        "ln1": {"scale": np.asarray(sd[f"{prefix}.norm1.weight"]),
                "bias": np.asarray(sd[f"{prefix}.norm1.bias"])},
        "ln2": {"scale": np.asarray(sd[f"{prefix}.norm2.weight"]),
                "bias": np.asarray(sd[f"{prefix}.norm2.bias"])},
    }


def convert_transmvsnet(sd: Dict, n_stages: int = 3) -> Dict:
    f = "feature"
    feat = {
        "conv0": [_conv_block(sd, f"{f}.conv0.{i}") for i in range(2)],
        "conv1": [_conv_block(sd, f"{f}.conv1.{i}") for i in range(3)],
        "conv2": [_conv_block(sd, f"{f}.conv2.{i}") for i in range(3)],
        "out1": _dcn_head(sd, f"{f}.out1"),
        "inner1": _plain_conv(sd, f"{f}.inner1"),
        "inner2": _plain_conv(sd, f"{f}.inner2"),
        "out2": _dcn_head(sd, f"{f}.out2"),
        "out3": _dcn_head(sd, f"{f}.out3"),
    }
    fmt = {
        "fmt": {"layers": [
            _encoder_layer(sd, f"FMT_with_pathway.FMT.layers.{i}")
            for i in range(8)]},
        "dim_reduction_1": _plain_conv(sd,
                                       "FMT_with_pathway.dim_reduction_1"),
        "dim_reduction_2": _plain_conv(sd,
                                       "FMT_with_pathway.dim_reduction_2"),
        "smooth_1": _plain_conv(sd, "FMT_with_pathway.smooth_1"),
        "smooth_2": _plain_conv(sd, "FMT_with_pathway.smooth_2"),
    }
    pixelwise = {
        "conv0": {"w": conv3d_w(np.asarray(
            sd["DepthNet.pixel_wise_net.conv0.conv.weight"])),
            "bn": _bn(sd, "DepthNet.pixel_wise_net.conv0.bn")},
        "conv1": {"w": conv3d_w(np.asarray(
            sd["DepthNet.pixel_wise_net.conv1.conv.weight"])),
            "bn": _bn(sd, "DepthNet.pixel_wise_net.conv1.bn")},
        "conv2": _plain_conv(sd, "DepthNet.pixel_wise_net.conv2", "conv3d"),
    }
    cost_reg = []
    for s in range(n_stages):
        cr = f"cost_regularization.{s}"
        cost_reg.append({
            "conv0": _conv_block(sd, f"{cr}.conv0", "conv3d"),
            "conv1": _conv_block(sd, f"{cr}.conv1", "conv3d"),
            "conv2": _conv_block(sd, f"{cr}.conv2", "conv3d"),
            "conv3": _conv_block(sd, f"{cr}.conv3", "conv3d"),
            "conv4": _conv_block(sd, f"{cr}.conv4", "conv3d"),
            "conv5": _conv_block(sd, f"{cr}.conv5", "conv3d"),
            "conv6": _conv_block(sd, f"{cr}.conv6", "conv3d"),
            "conv7": _conv_block(sd, f"{cr}.conv7", "deconv3d"),
            "conv9": _conv_block(sd, f"{cr}.conv9", "deconv3d"),
            "conv11": _conv_block(sd, f"{cr}.conv11", "deconv3d"),
            "prob": _plain_conv(sd, f"{cr}.prob", "conv3d"),
        })
    return {"feature": feat, "fmt": fmt, "pixelwise": pixelwise,
            "cost_reg": cost_reg}


# --------------------------------------------------------------------------
# BN folding for the reference ConvBnReLU3D blocks in PixelwiseNet:
# our conv3d applies BN from the "bn" subtree, handled above.
# --------------------------------------------------------------------------

# --------------------------------------------------------------------------
# VolSDF (reference volsdf/model/network.py:10-204). Handles both
# weight-norm (weight_g/weight_v) and plain (weight) linear layers.
# --------------------------------------------------------------------------

def _wn_linear(sd: Dict, prefix: str) -> Dict:
    if f"{prefix}.weight_v" in sd:
        v = np.asarray(sd[f"{prefix}.weight_v"])       # (out, in)
        g = np.asarray(sd[f"{prefix}.weight_g"])       # (out, 1)
        return {"v": linear_w(v), "g": g[:, 0],
                "b": np.asarray(sd[f"{prefix}.bias"])}
    # torch >= 2.1 parametrized weight norm
    if f"{prefix}.parametrizations.weight.original1" in sd:
        v = np.asarray(sd[f"{prefix}.parametrizations.weight.original1"])
        g = np.asarray(sd[f"{prefix}.parametrizations.weight.original0"])
        return {"v": linear_w(v), "g": g.reshape(-1),
                "b": np.asarray(sd[f"{prefix}.bias"])}
    return {"w": linear_w(np.asarray(sd[f"{prefix}.weight"])),
            "b": np.asarray(sd[f"{prefix}.bias"])}


def convert_volsdf(sd: Dict, n_sdf_layers: int = 9,
                   n_rgb_layers: int = 5, with_background: bool = False,
                   n_bg_sdf_layers: int = 9,
                   n_bg_rgb_layers: int = 2) -> Dict:
    """Reference VolSDFNetwork(BG) state_dict -> our param pytree.
    Layer counts: len(dims)+1 linear layers per MLP."""
    out = {
        "sdf": [_wn_linear(sd, f"implicit_network.lin{i}")
                for i in range(n_sdf_layers)],
        "rgb": [_wn_linear(sd, f"rendering_network.lin{i}")
                for i in range(n_rgb_layers)],
        "density": {"beta": np.asarray(sd["density.beta"]).reshape(())},
    }
    if with_background:
        out["bg_sdf"] = [_wn_linear(sd, f"bg_implicit_network.lin{i}")
                         for i in range(n_bg_sdf_layers)]
        out["bg_rgb"] = [_wn_linear(sd, f"bg_rendering_network.lin{i}")
                         for i in range(n_bg_rgb_layers)]
    return out


# --------------------------------------------------------------------------
# LPIPS (torch `lpips` package, net='vgg'): VGG16 slices + 1x1 lins.
# Replaces the reference's TF1 frozen-graph download
# (lpips_tensorflow/lpips_tf.py:29-90).
# --------------------------------------------------------------------------

# torchvision vgg16.features conv layer indices per LPIPS slice.
_VGG_SLICES = (("slice1", (0, 2)), ("slice2", (5, 7)),
               ("slice3", (10, 12, 14)), ("slice4", (17, 19, 21)),
               ("slice5", (24, 26, 28)))


def convert_lpips(sd: Dict) -> Dict:
    feats, lins = [], []
    for i, (slice_name, conv_ids) in enumerate(_VGG_SLICES):
        block = []
        for ci in conv_ids:
            w = np.asarray(sd[f"net.{slice_name}.{ci}.weight"])
            b = np.asarray(sd[f"net.{slice_name}.{ci}.bias"])
            block.append({"w": conv2d_w(w), "b": b})
        feats.append(block)
        lw = np.asarray(sd[f"lin{i}.model.1.weight"])  # (1, C, 1, 1)
        lins.append({"w": lw[:, :, 0, 0].T})            # (C, 1)
    return {"features": feats, "lins": lins}


CONVERTERS = {
    "casmvsnet": convert_casmvsnet,
    "ucsnet": convert_ucsnet,
    "transmvsnet": convert_transmvsnet,
    "volsdf": convert_volsdf,
    "lpips": convert_lpips,
}


def _deep_copy_arrays(obj):
    """Decouple a converted pytree from the source module's storage.

    ``tensor.detach().cpu().numpy()`` (and ``np.asarray`` on a CPU
    tensor) returns a VIEW of the live parameter memory, and the
    view-preserving layout transforms here (``linear_w`` transpose,
    ``g[:, 0]`` slice, ``reshape``) keep that aliasing — so in-place
    training of the source torch module (``optimizer.step()``) would
    silently rewrite the "converted init". Measured before this copy:
    training the reference VolSDF model mutated 25/25 leaves of the
    converted pytree. Copy once at the boundary so every converter is
    safe by construction.
    """
    if isinstance(obj, dict):
        return {k: _deep_copy_arrays(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_deep_copy_arrays(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return np.array(obj)
    return obj


def convert(model: str, state_dict: Dict, **kwargs) -> Dict:
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else
          np.asarray(v) for k, v in state_dict.items()}
    return _deep_copy_arrays(CONVERTERS[model](sd, **kwargs))


def main(argv: Optional[List[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--model", required=True, choices=list(CONVERTERS))
    p.add_argument("--ckpt", required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    import torch
    raw = torch.load(args.ckpt, map_location="cpu", weights_only=True)
    sd = raw.get("model", raw) if isinstance(raw, dict) else raw
    params = convert(args.model, sd)

    ckpt.save_state(args.out, ckpt.tree_leaves(params), model=args.model)
    print(f"converted {args.ckpt} -> {args.out}")


if __name__ == "__main__":
    main()
