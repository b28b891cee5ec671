"""The port's precision knobs against the JAX package's, at the small size
of test_torch_config.shrink with its float32 lines put back to the JAX
defaults where a test says so.

Bars, in bf16 units (u = 2^-8, the spacing of bf16 values in [1, 2) is
2u): the two frameworks round at other places (the JAX bf16 softplus is
computed as XLA fuses it, the port's as torch's eager ops round each
step; their weight norms differ in the last float32 bit, which can move
a bf16 rounding of a weight), so a value differs from JAX by a few
roundings of its own size, |d| <= k u (|want| + 1):
  * float32 (compute, activation): 2e-4 absolute, the VolSDF bar;
  * bf16 values (sdf, features, rgb, a layer's output): k = 4;
  * gradients through bf16 activations (the cotangents are bf16 too,
    rounded after every backward op on both sides): k = 8.
"""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.models import layers as jlayers
from s_volsdf_tpu.models import network as jnet
from s_volsdf_tpu_torch.models import layers as tlayers
from s_volsdf_tpu_torch.models import network as tnet
from test_torch_config import IMG_RES, VOL, params_pair, shrink, small_configs

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

U = 2.0 ** -8
F32_BAR = 2e-4
PAIRS = [("float32", "float32"), ("bfloat16", "float32"),
         ("bfloat16", "bfloat16")]


def assert_within(got, want, k, what=""):
    """|got - want| <= k u (|want| + 1) elementwise, or 2e-4 for k=None."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = F32_BAR if k is None else k * U * (np.abs(want) + 1.0)
    err = np.abs(got - want)
    assert np.all(err <= bar), (what, float(err.max()),
                                float((err / (np.abs(want) + 1.0)).max()))


def _inputs(n=256, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.normal(size=(n, 3)).astype(np.float32)
    pts[::9] *= 2.5      # some points outside the bounding sphere
    return (pts, rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 32)).astype(np.float32))


def _models(compute, activation):
    jcfg, tcfg = small_configs()
    return (dataclasses.replace(jcfg.model, compute_dtype=compute,
                                activation_dtype=activation),
            dataclasses.replace(tcfg.model, compute_dtype=compute,
                                activation_dtype=activation), jcfg)


@pytest.mark.parametrize("compute,x_dtype", [
    (None, "float32"), ("bfloat16", "float32"), ("bfloat16", "bfloat16")])
def test_apply_linear_matches_jax(compute, x_dtype):
    """One weight-normed layer: float32 products, or bf16 operands with
    a float32 product and bias (also for an input that is bf16 already,
    as bf16 activations hand it on)."""
    _, _, jcfg = _models("float32", "float32")
    jp, tp = params_pair(jcfg, seed=3)
    x = np.random.default_rng(1).normal(size=(64, 32)).astype(np.float32)
    jx, tx = jnp.asarray(x), torch.tensor(x)
    if x_dtype == "bfloat16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    want = jlayers.apply_linear(jp["sdf"][1], jx,
                                jnp.bfloat16 if compute else None)
    got = tlayers.apply_linear(tp.sdf[1], tx,
                               torch.bfloat16 if compute else None)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_within(got.detach().numpy(), want, 4 if compute else None)
    if compute:   # the operands were rounded: not the float32 product
        f32 = tlayers.apply_linear(tp.sdf[1], tx.float())
        assert not torch.equal(got, f32)


def _run_jax(jp, jm, pts, nrm, dirs, feats):
    sdf, feat, grad = jnet.sdf_feat_grad(jp["sdf"], jm, jnp.asarray(pts), 3.0)
    return {"sdf_values": jnet.sdf_values(jp["sdf"], jm, pts, 3.0),
            "sdf": sdf, "feat": feat, "grad": grad,
            "eik": jnet.sdf_gradient(jp["sdf"], jm, jnp.asarray(pts), 3.0),
            "rgb": jnet.rgb_mlp(jp["rgb"], jm, pts, nrm, dirs, feats)}


def _run_port(tp, tm, pts, nrm, dirs, feats):
    t = [torch.tensor(a) for a in (pts, nrm, dirs, feats)]
    sdf, feat, grad = tnet.sdf_feat_grad(tp.sdf, tm, t[0], 3.0)
    with torch.no_grad():
        out = {"sdf_values": tnet.sdf_values(tp.sdf, tm, t[0], 3.0),
               "rgb": tnet.rgb_mlp(tp.rgb, tm, *t)}
    out.update(sdf=sdf, feat=feat, grad=grad,
               eik=tnet.sdf_gradient(tp.sdf, tm, t[0], 3.0))
    return {k: v.detach().numpy() for k, v in out.items()}


@pytest.mark.parametrize("compute,activation", PAIRS)
def test_network_matches_jax(compute, activation):
    """sdf_values, sdf_feat_grad (values, features, the clamped SDF's
    spatial gradient), sdf_gradient (the eikonal gradient) and rgb_mlp,
    each against JAX under the same (compute, activation) pair."""
    jm, tm, jcfg = _models(compute, activation)
    jp, tp = params_pair(jcfg, seed=3)
    args = _inputs()
    want = _run_jax(jp, jm, *args)
    got = _run_port(tp, tm, *args)
    bf16 = compute == "bfloat16"
    for name in want:
        grad = name in ("grad", "eik") and activation == "bfloat16"
        assert_within(got[name], want[name],
                      (8 if grad else 4) if bf16 else None, name)
        assert got[name].dtype == np.float32, name


def test_bf16_activations_need_bf16_products():
    """(float32, bfloat16) is (float32, float32) to the bit: bf16
    activations engage only alongside bf16 products, the port's
    counterpart of tests/test_mixed_precision.py:85."""
    _, tm32, jcfg = _models("float32", "float32")
    _, tm_mixed, _ = _models("float32", "bfloat16")
    _, tp = params_pair(jcfg, seed=3)
    assert tnet.activation_dtype(tm_mixed) is None
    a, b = (_run_port(tp, tm, *_inputs()) for tm in (tm32, tm_mixed))
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.mark.parametrize("compute,activation", PAIRS[1:])
def test_bf16_changes_the_port(compute, activation):
    """Each bf16 setting changes the port's outputs against float32 (the
    knob is live in the network, not only in JAX)."""
    _, tm32, jcfg = _models("float32", "float32")
    _, tm, _ = _models(compute, activation)
    _, tp = params_pair(jcfg, seed=3)
    a, b = (_run_port(tp, m, *_inputs()) for m in (tm32, tm))
    assert not np.array_equal(a["sdf_values"], b["sdf_values"])
    assert not np.array_equal(a["eik"], b["eik"])


# Each knob alone changes what the port computes (the counterpart of
# tests/test_mixed_precision.py's test_production_bf16_flags_are_live):
# (knob, what it is switched from, and the setting it needs to matter).
KNOBS = [
    ("train.train_compute_dtype", {}),
    ("train.train_activation_dtype", {"train.train_compute_dtype": "bfloat16"}),
    ("train.mvs_pack_dtype", {}),
    ("train.feedback_render_dtype", {}),
    ("model.compute_dtype", {}),
    ("model.activation_dtype", {"model.compute_dtype": "bfloat16"}),
]


def _trainer(settings):
    cfg = shrink(chip_smoke.float32_dtu_config())
    for key, value in settings.items():
        section, name = key.split(".")
        setattr(getattr(cfg, section), name, value)
    return chip_smoke.make_trainer(cfg, IMG_RES, VOL, "cpu")


def _outputs(trainer, knob):
    """What the knob feeds: a training step's loss terms and updated
    parameters, or a feedback render's depth."""
    if knob.startswith("train.") and knob != "train.feedback_render_dtype":
        trainer.run(1)
        lo = trainer.losses[0]
        return np.concatenate([[lo.loss, lo.mvs_loss, lo.eikonal_loss]] + [
            p.detach().numpy().ravel()
            for p in trainer.state.params.parameters()])
    return trainer.render_mvs(0, res_scale=0.5, chunk=64)


@pytest.mark.parametrize("knob,base", KNOBS)
def test_precision_knob_is_live(knob, base):
    """The knob alone, float32 -> bfloat16, changes the port's output;
    the output stays finite."""
    a = _outputs(_trainer(base), knob)
    b = _outputs(_trainer({**base, knob: "bfloat16"}), knob)
    assert np.isfinite(b).all()
    assert not np.array_equal(a, b), knob
