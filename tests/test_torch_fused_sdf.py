"""The port's fused-SDF wrapper on the CPU (its plain PyTorch version)
against the JAX package's Pallas kernel in interpret mode and against
JAX `sdf_values`, at the full dtu width (8x256, skip at 4, multires 6)
on 700 points (a ragged tail for the kernel's tiles), clamped at the
bounding sphere and (the background model's sweeps) unclamped out to
twice its radius.

Tolerance 3e-5 absolute, the bar tests/test_pallas_fused_sdf.py holds
the Pallas kernel to: float32 sums in another order across 9 layers.
The kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py); here its pack is checked, and its split arithmetic is
emulated from the pack and held to the plain version.

The bfloat16 mode (compute_dtype "bfloat16"): its plain version against
JAX `sdf_values` under the same precision, within 4 bf16 units of the
value (4 * 2^-8 (|want| + 1)): the two round the same operations, the
softplus op by op, after sums in other orders and weight norms a float32
bit apart (tests/test_torch_precision.py). Its pack holds
W_hi alone, and its arithmetic emulated from the pack, with the
kernel's accumulation (bias first, then K chunk by K chunk), is held to
the plain version within 2^-8 (|want| + 1): one accumulation order
against another moves a bf16 rounding of an activation now and then,
and with it the SDF by about 1e-3 at the dtu width (8e-4 (|want| + 1)
measured here). The card's bar is 2^-6 (|want| + 1): wgmma's order,
over up to 2,097,152 points, moved it by up to 3.2e-3 (|want| + 1).
"""

import dataclasses

import os
import sys

import jax
import numpy as np
import pytest
import torch

from s_volsdf_tpu.config import load_config
from s_volsdf_tpu.models.network import init_volsdf_params, sdf_values
from s_volsdf_tpu.ops.pallas.fused_sdf import fused_sdf_values as jax_fused
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.bridge import from_jax_params
from s_volsdf_tpu_torch.models.embedder import positional_encoding
from s_volsdf_tpu_torch.models.layers import softplus_b
from s_volsdf_tpu_torch.models.network import init_volsdf_params as tinit
from s_volsdf_tpu_torch.models.network import sdf_values as tsdf_values
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import IMG_RES, VOL, shrink

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402


def test_fused_sdf_plain_matches_jax():
    jcfg = load_config("dtu")
    tcfg = tconfig.dtu_config()
    assert fused_sdf.supported(tcfg.model)
    jp = init_volsdf_params(jax.random.PRNGKey(0), jcfg.model)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    pts = np.random.default_rng(1).normal(size=(700, 3)).astype(np.float32)
    pts[::7] *= 2.5   # some points outside the bounding sphere

    ref = np.asarray(sdf_values(jp["sdf"], jcfg.model, pts, 3.0))
    ref_pallas = np.asarray(jax_fused(jp["sdf"], jcfg.model, pts, 3.0,
                                      interpret=True))
    before = fused_sdf.fused_sdf_values.launches
    got = fused_sdf.fused_sdf_values(tp.sdf, tcfg.model,
                                     torch.tensor(pts), 3.0).numpy()
    # A CPU tensor takes the plain version and launches nothing.
    assert fused_sdf.fused_sdf_values.launches == before
    assert got.shape == (700,)
    np.testing.assert_allclose(got, ref, atol=3e-5)
    np.testing.assert_allclose(got, ref_pallas, atol=3e-5)
    # The autograd-capable SDF of models/network.py computes the same.
    with torch.no_grad():
        got_net = tsdf_values(tp.sdf, tcfg.model, torch.tensor(pts), 3.0)
    np.testing.assert_allclose(got_net.numpy(), ref, atol=3e-5)
    # The bounding-sphere clamp is live on the far points.
    far = np.linalg.norm(pts, axis=-1) > 3.2
    assert far.sum() > 10 and np.all(got[far] < 0)

    # Unclamped (bounding_sphere 0, the background model's sweeps) on
    # points out to 2r: the Pallas kernel's clamp-free branch.
    rng = np.random.default_rng(2)
    d = rng.normal(size=(700, 3))
    ball = (d / np.linalg.norm(d, axis=-1, keepdims=True)
            * 6.0 * rng.uniform(0, 1, (700, 1)) ** (1 / 3)).astype(np.float32)
    ref0 = np.asarray(jax_fused(jp["sdf"], jcfg.model, ball, 0.0,
                                interpret=True))
    got0 = fused_sdf.fused_sdf_values(tp.sdf, tcfg.model,
                                      torch.tensor(ball), 0.0).numpy()
    np.testing.assert_allclose(got0, ref0, atol=3e-5)
    outside = np.linalg.norm(ball, axis=-1) > 3.0
    assert outside.sum() > 300 and np.all(got0[outside] > 0)


@pytest.mark.parametrize("activation", ["float32", "bfloat16"])
def test_fused_sdf_plain_bf16_matches_jax(activation):
    """The bfloat16 mode's plain version against JAX `sdf_values` under
    compute_dtype bfloat16 (the XLA path the JAX step runs; the Pallas
    kernel is float32 only), dtu width, 700 points."""
    jcfg = load_config("dtu")
    tcfg = tconfig.dtu_config()
    jm = dataclasses.replace(jcfg.model, compute_dtype="bfloat16",
                             activation_dtype=activation)
    tm = dataclasses.replace(tcfg.model, compute_dtype="bfloat16",
                             activation_dtype=activation)
    jp = init_volsdf_params(jax.random.PRNGKey(0), jcfg.model)
    tp = from_jax_params(jax.tree.map(np.asarray, jp))
    pts = np.random.default_rng(1).normal(size=(700, 3)).astype(np.float32)
    pts[::7] *= 2.5
    want = np.asarray(sdf_values(jp["sdf"], jm, pts, 3.0))
    got = fused_sdf.fused_sdf_values(tp.sdf, tm, torch.tensor(pts),
                                     3.0).numpy()
    err = np.abs(got - want)
    assert np.all(err <= 4 * 2.0 ** -8 * (np.abs(want) + 1)), err.max()
    # bf16, not float32: the float32 plain version is further from it.
    f32 = fused_sdf.sdf_values_plain(tp.sdf, tcfg.model, torch.tensor(pts),
                                     3.0).numpy()
    assert np.abs(f32 - want).max() > err.max()


def _every_bf16():
    """Every finite bf16 value, as float32."""
    v = (np.arange(1 << 16, dtype=np.uint32) << 16).view(np.float32)
    return v[np.isfinite(v)]


def _bf16_bits(x) -> np.ndarray:
    """float32 values (float64 allowed) rounded to nearest bf16, as their
    16 bits (uint32)."""
    t = torch.from_numpy(np.asarray(x, np.float32)).to(torch.bfloat16)
    return t.view(torch.int16).numpy().astype(np.uint32) & 0xFFFF


def emulate_act_bf16(z, table):
    """csrc/fused_sdf.cu's act2_bf16 on one 16-bit lane, bit for bit, in
    numpy: h = bf16(z); the closed form max(bf16(bf16(100 h) * 0.01f), 0)
    (the bf16 product rounded once); the table's index rot16(h, 1)
    clamped to [2 ACT_LO - 1, 2 ACT_LO + 2 ACT_SPAN] and offset; the
    closed form where the entry is the sentinel. Returns float32."""
    with np.errstate(over="ignore", invalid="ignore"):
        h = _bf16_bits(z)
        z100 = _bf16_bits((h << 16).view(np.float32).astype(np.float64) * 100)
        big = _bf16_bits((z100 << 16).view(np.float32) * np.float32(0.01))
    big = np.where((big << 16).view(np.float32) > 0, big, 0)
    rot = ((h << 1) & 0xFFFE) | (h >> 15)
    lo = 2 * fused_sdf.ACT_LO - 1
    t = np.minimum(np.maximum(rot, lo) - lo, 2 * fused_sdf.ACT_SPAN + 1)
    r = table.numpy().astype(np.uint32)[t] & 0xFFFF
    return (np.where(r >> 15, big, r).astype(np.uint32) << 16).view(np.float32)


@pytest.mark.parametrize("form", ["plain", "table"])
def test_bf16_softplus_rounds_as_jax_on_every_input(form):
    """The bfloat16 mode's activation against the JAX package's
    `layers.softplus_b` on h.astype(bf16), jitted on the CPU, over every
    finite bf16 h: its plain form (`act_bf16_values` on the CPU), and the
    kernel's act2_bf16 emulated from its table built on the CPU
    (`act_bf16_table`; on the card the kernel is held to torch's bf16
    ops, chip_smoke.py phase 3), which also equals the plain form bit
    for bit. Equal wherever either result is a normal float (XLA on the
    CPU flushes subnormal results to 0: 14 inputs near h = -0.85,
    results under 1e-38). XLA's fused loop keeps a round trip to bf16
    after each op, so JAX's bf16 program rounds op by op. The softplus
    rounded once, as the sampler's sweep computed it before, differs on
    4,091 of the 65,280 inputs."""
    from s_volsdf_tpu.models import layers as jlayers
    h = _every_bf16()
    # bf16 out of the program: XLA drops the quotient's rounding when
    # the program goes on to convert it to float32 (excess precision)
    want = np.asarray(jax.jit(lambda x: jlayers.softplus_b(
        x.astype(jax.numpy.bfloat16), beta=100.0))(h)).astype(np.float32)
    plain = fused_sdf.act_bf16_values(torch.from_numpy(h)).numpy()
    if form == "plain":
        got = plain
    else:
        got = emulate_act_bf16(h, fused_sdf.act_bf16_table("cpu"))
        assert np.array_equal(got.view(np.uint32), plain.view(np.uint32))
    normal = np.maximum(np.abs(got), np.abs(want)) >= np.finfo(np.float32).tiny
    same = (got == want) | (np.isnan(got) & np.isnan(want))
    assert np.all(same | ~normal), h[~same & normal][:8]
    once = fused_sdf.bf16r(softplus_b(fused_sdf.bf16r(torch.from_numpy(h)),
                                      beta=100.0)).numpy()
    assert np.sum(once != want) > 4000


def test_act_bf16_table_layout():
    """The kernel's table (`act_bf16_table`): int16 bf16 bits,
    ACT_TABLE_LEN long (whole 16 bytes); entry 0 the activation of 0,
    entry 1 + 2 (m - ACT_LO) + sign the activation of the bf16 value
    with sign and |bits| m, for m in the band; then the sentinel 0x8000
    (-0.0: no activation has its sign bit set) and zeros; one tensor per
    device, built once."""
    table = fused_sdf.act_bf16_table("cpu")
    assert table is fused_sdf.act_bf16_table(torch.device("cpu"))
    assert table.dtype == torch.int16 and table.numel() == 4104
    assert fused_sdf.ACT_TABLE_LEN * 2 % 16 == 0
    span = fused_sdf.ACT_SPAN
    assert span == 2048
    bits = table.numpy().astype(np.uint32) & 0xFFFF
    act = fused_sdf.act_bf16_values
    for m in (fused_sdf.ACT_LO, 0x3A00, fused_sdf.ACT_HI - 1):
        for sign in (0, 1):
            h = np.array([(m | sign << 15) << 16], np.uint32).view(np.float32)
            want = _bf16_bits(act(torch.from_numpy(h)).numpy())[0]
            assert bits[1 + 2 * (m - fused_sdf.ACT_LO) + sign] == want
    assert bits[0] == _bf16_bits(act(torch.zeros(1)).numpy())[0] == 0x3BE3
    assert bits[2 * span + 1] == fused_sdf.ACT_SENTINEL == 0x8000
    assert np.all(bits[:2 * span + 1] < 0x8000)
    assert np.all(bits[2 * span + 2:] == 0)


@pytest.mark.parametrize("form", ["below", "negative", "positive"])
def test_act_bf16_band_edges(form):
    """The band's edges (2^-16 <= |h| < 1) and each closed form on every
    finite bf16 input it covers, against the plain form: below the band
    the activation of 0 (both signs); h <= -1, 0; h >= 1,
    bf16(bf16(100 h) * 0.01f). Each form fails inside the band, so the
    table is needed there: the exact edges are |h| bits 0x37A4 (above 0),
    0x3877 (below 0), 0x3D2A (the closed form above 0), 0x3F62 (0 below
    0), all inside [ACT_LO, ACT_HI)."""
    assert (fused_sdf.ACT_LO, fused_sdf.ACT_HI) == (0x3780, 0x3F80)
    h = _every_bf16()
    bits = h.view(np.uint32) >> 16
    m, neg = bits & 0x7FFF, bits >> 15 == 1
    plain = fused_sdf.act_bf16_values(torch.from_numpy(h)).numpy()
    with np.errstate(over="ignore"):
        up = (_bf16_bits(((_bf16_bits(h.astype(np.float64) * 100) << 16)
                          .view(np.float32)) * np.float32(0.01)) << 16
              ).view(np.float32)
    near0 = np.full_like(h, fused_sdf.act_bf16_values(torch.zeros(1)).item())
    closed, side = {"below": (near0, np.ones_like(neg)),
                    "negative": (np.zeros_like(h), neg),
                    "positive": (up, ~neg)}[form]
    ok = closed.view(np.uint32) == plain.view(np.uint32)
    outside = (m < fused_sdf.ACT_LO) if form == "below" else \
        (m >= fused_sdf.ACT_HI)
    assert np.all(ok[side & outside])
    # The closed form's own edge inside the band.
    inside = side & ~outside & ~ok
    edge = {"below": m[inside].min(), "negative": m[inside].max() + 1,
            "positive": m[inside].max() + 1}[form]
    if form == "below":
        assert m[inside & ~neg].min() == 0x37A4
        assert m[inside & neg].min() == 0x3877
        assert edge > fused_sdf.ACT_LO
    else:
        assert edge == {"negative": 0x3F62, "positive": 0x3D2A}[form]
        assert edge < fused_sdf.ACT_HI
        assert np.all(ok[side & (m >= edge)])


def test_bf16_quotient_as_multiply_rounds_as_division():
    """csrc/fused_sdf.cu's act2_bf16 divides the bf16 sum s = bf16(100 h)
    by 100 as s * 0.01f above its table's band, before its rounding to
    bf16 (the table itself is torch's bf16 ops): for every finite bf16 s
    that rounds to the bf16 of s / 100, in float32 as torch's bf16
    division computes it and exactly."""
    s = _every_bf16()
    mul = torch.from_numpy(s * np.float32(0.01)).to(torch.bfloat16)
    div = torch.from_numpy(s).to(torch.bfloat16) / 100
    exact = torch.from_numpy(s.astype(np.float64) / 100).to(torch.bfloat16)
    assert torch.equal(mul.view(torch.int16), div.view(torch.int16))
    assert torch.equal(mul.view(torch.int16), exact.view(torch.int16))


def test_supported_family():
    cfg = tconfig.dtu_config()
    assert fused_sdf.supported(cfg.model)
    cfg.model.implicit.skip_in = (2, 4)
    assert not fused_sdf.supported(cfg.model)
    cfg = tconfig.dtu_config()
    cfg.model.implicit.dims = (512,) * 8
    assert not fused_sdf.supported(cfg.model)


def _stage(pack, l, c, lo=0):
    """Index in the stream of layer l's stage for K chunk c, W_hi (lo=0)
    or W_lo (lo=1)."""
    return 2 * (sum(list(pack.meta.chunks)[:l]) + c) + lo


def _pack_layers(pack):
    """The pack's hidden layers back as (W_hi, W_lo), each (256 out,
    64 * chunks in) bf16, from the swizzled stage stream."""
    w = fused_sdf.swizzle128(pack.weights)    # its own inverse
    layers = [tuple(torch.cat([w[_stage(pack, l, c, lo)]
                               for c in range(pack.meta.chunks[l])], dim=1)
                    for lo in (0, 1))
              for l in range(pack.meta.n_hidden)]
    assert _stage(pack, pack.meta.n_hidden, 0) == pack.meta.n_stages \
        == pack.weights.shape[0]
    return layers


def test_packed_layout_matches_weights():
    """The kernel's pack: every hidden layer's materialised weight,
    transposed to (out, in) (K-major), as hi + lo within the split's
    relative error; zero padding to N = 256 and to whole K chunks of 64;
    the skip layer's 1/sqrt(2) folded in; the 128-byte swizzle; the
    biases, then the SDF column and bias as the last layer."""
    cfg = tconfig.dtu_config()
    params = tinit(torch.Generator().manual_seed(0), cfg.model)
    pack = fused_sdf.pack_sdf(params.sdf, cfg.model)
    meta = pack.meta
    wb = fused_sdf.normalized_weights(params.sdf)
    assert meta.n_hidden == 8 and meta.skip == 4 and meta.d_pe == 39
    assert meta.pe_col == 217 and meta.n_stages == 58
    assert list(meta.chunks)[:8] == [1] + [4] * 7
    assert pack.weights.dtype == torch.bfloat16
    assert tuple(pack.weights.shape) == (58, 256, 64)
    layers = _pack_layers(pack)
    for l, ((hi, lo), (w, b)) in enumerate(zip(layers, wb)):
        k, n = w.shape
        want = w.T * (fused_sdf.INV_SQRT2 if l == 4 else 1.0)
        got = hi.float() + lo.float()
        assert torch.all((got[:n, :k] - want).abs()
                         <= fused_sdf.SPLIT_REL_ERR * want.abs())
        assert hi.float()[:n, :k].sub(want).abs().max() > 0   # lo is needed
        assert torch.all(got[n:] == 0) and torch.all(got[:, k:] == 0)
        torch.testing.assert_close(pack.vec[l * 256:l * 256 + n], b,
                                   rtol=0, atol=0)
        assert torch.all(pack.vec[l * 256 + n:(l + 1) * 256] == 0)
    # The fold: layer 4's packed weights are 1/sqrt(2) of its own.
    ratio = (layers[4][0].float() + layers[4][1].float())[:256, :256] \
        / wb[4][0].T
    assert torch.allclose(ratio[wb[4][0].T != 0],
                          torch.tensor(fused_sdf.INV_SQRT2), rtol=1e-5)
    # The swizzle, by its formula: (n, k) of a stage sits in row n at
    # 16-byte unit (k // 8) ^ (n % 8).
    hi1 = layers[1][0]
    for n in (0, 5, 13, 130, 255):
        for k in (0, 9, 63, 64 + 17, 255):
            c, kc = divmod(k, 64)
            raw = pack.weights[_stage(pack, 1, c), n,
                               8 * ((kc // 8) ^ (n % 8)) + kc % 8]
            assert raw == hi1[n, k]
    # The SDF layer: its column 0 and its bias[0].
    w8, b8 = wb[8]
    torch.testing.assert_close(pack.vec[8 * 256:9 * 256], w8[:, 0],
                               rtol=0, atol=0)
    assert torch.all(pack.vec[9 * 256:9 * 256 + 64] == 0)   # no skip there
    assert pack.vec[-1] == b8[0] and pack.vec.numel() == 9 * 256 + 64 + 1


def emulate_kernel(pack, cfg, pts, bounding_sphere):
    """csrc/fused_sdf.cu's arithmetic in torch on the CPU, read from its
    pack: the positional encoding zero-padded to one K chunk; per hidden
    layer, the input split hi/lo as the kernel's epilogue splits it,
    A_hi W_hi + A_lo W_hi + A_hi W_lo over the K chunks accumulated in
    f32, bias, softplus, and the encoding in the columns before the skip
    junction; the SDF column as a dot product; the clamp."""
    meta, vec, W = pack.meta, pack.vec, fused_sdf.WIDTH
    pe = positional_encoding(pts, cfg.implicit.multires)
    h = torch.nn.functional.pad(pe, (0, fused_sdf.KCHUNK - pe.shape[1]))
    for l, (w_hi, w_lo) in enumerate(_pack_layers(pack)):
        k = w_hi.shape[1]
        a_hi, a_lo = (t.float() for t in fused_sdf.split_bf16(h[:, :k]))
        w_hi, w_lo = w_hi.float().T, w_lo.float().T
        acc = a_hi @ w_hi + a_lo @ w_hi + a_hi @ w_lo
        h = softplus_b(acc + vec[l * W:(l + 1) * W], beta=100.0)
        if l + 1 == meta.skip < meta.n_hidden:
            h[:, meta.pe_col:meta.pe_col + meta.d_pe] = pe
    n = meta.n_hidden
    sdf = h @ vec[n * W:(n + 1) * W] + vec[-1]
    if meta.skip == n:   # the SDF layer's own input ends in the encoding
        sdf = sdf + pe @ vec[(n + 1) * W:(n + 1) * W + meta.d_pe]
    if bounding_sphere > 0.0:
        r = torch.linalg.norm(pts, dim=-1)
        sdf = torch.minimum(sdf, cfg.implicit.sphere_scale
                            * (bounding_sphere - r))
    return sdf


# The dtu width, then the family members of tests/test_torch_cuda.py.
FAMILY = [
    ((256,) * 8, (4,), 6, 3.0),
    ((32,) * 4, (2,), 4, 3.0),
    ((64,) * 3, (), 2, 0.0),
    ((102,) * 5, (3,), 10, 3.0),
    ((64,) * 3, (3,), 4, 3.0),      # the skip junction feeds the SDF layer
]


@pytest.mark.parametrize("dims,skip_in,multires,bounding_sphere", FAMILY)
def test_kernel_emulation_matches_plain(dims, skip_in, multires,
                                        bounding_sphere):
    """The bf16 x 3 split predicts the card's error: the emulation is
    held within 1e-4 of the plain float32 version (the card's bar in
    chip_smoke.py and tests/test_torch_cuda.py) on the 700 points of the
    JAX parity test. A split with one product fewer fails here."""
    cfg = tconfig.dtu_config()
    imp = cfg.model.implicit
    imp.dims, imp.skip_in, imp.multires = dims, skip_in, multires
    if dims[0] != 256:
        cfg.model.feature_vector_size = 16
    params = tinit(torch.Generator().manual_seed(0), cfg.model)
    pts = torch.tensor(np.random.default_rng(1).normal(size=(700, 3)),
                       dtype=torch.float32)
    pts[::7] *= 2.5
    pack = fused_sdf.pack_sdf(params.sdf, cfg.model)
    want = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts,
                                      bounding_sphere)
    with torch.no_grad():
        got = emulate_kernel(pack, cfg.model, pts, bounding_sphere)
    err = (got - want).abs().max().item()
    print(f"emulated bf16 x 3 kernel vs plain, dims {dims}: max|diff| "
          f"{err:.3e}")   # the card's predicted error (pytest -s)
    assert err <= 1e-4, err
    assert err > 0.0   # the split is not exact: the emulation is live


def _bf16_cfg(dims, skip_in, multires, activation):
    cfg = tconfig.dtu_config()
    imp = cfg.model.implicit
    imp.dims, imp.skip_in, imp.multires = dims, skip_in, multires
    if dims[0] != 256:
        cfg.model.feature_vector_size = 16
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.activation_dtype = activation
    return cfg


def _bf16_pack_layers(pack):
    """The bfloat16 pack's hidden layers back as W_hi (256 out, 64 *
    chunks in), one stage per K chunk."""
    w = fused_sdf.swizzle128(pack.weights)
    starts = np.cumsum([0] + list(pack.meta.chunks)[:pack.meta.n_hidden])
    assert starts[-1] == pack.meta.n_stages == pack.weights.shape[0]
    return [torch.cat([w[starts[l] + c]
                       for c in range(pack.meta.chunks[l])], dim=1)
            for l in range(pack.meta.n_hidden)]


def emulate_bf16_kernel(pack, cfg, pts, bounding_sphere):
    """csrc/fused_sdf.cu's bfloat16 mode in torch on the CPU, read from
    its pack: each layer's bf16 input times W_hi accumulated onto the
    bias K chunk by K chunk; with bf16 activations the pre-activation
    rounded to bf16 and the softplus computed op by op in bf16 (the
    kernel's act2_bf16 from its table, emulate_act_bf16); the junction's
    scale applied before the rounding
    to the next operand (hand_on, pe_hand_on); the SDF column as a dot
    product; the clamp."""
    meta, vec, W = pack.meta, pack.vec, fused_sdf.WIDTH
    r = fused_sdf.bf16r
    table = fused_sdf.act_bf16_table("cpu")

    def hand_on(z, scale):
        if meta.act_bf16:
            v = torch.from_numpy(emulate_act_bf16(z.numpy(), table))
        else:
            v = softplus_b(z, beta=100.0)
        return r(v * scale)

    def pe_hand_on(p, scale):
        return r((r(p) if meta.act_bf16 else p) * scale)

    pe = positional_encoding(pts, cfg.implicit.multires)
    h = torch.nn.functional.pad(pe_hand_on(pe, 1.0),
                                (0, fused_sdf.KCHUNK - pe.shape[1]))
    for l, w_hi in enumerate(_bf16_pack_layers(pack)):
        w = w_hi.float().T
        acc = vec[l * W:(l + 1) * W].expand(h.shape[0], W)
        for c in range(0, w.shape[0], fused_sdf.KCHUNK):
            acc = acc + h[:, c:c + fused_sdf.KCHUNK] @ w[c:c + fused_sdf.KCHUNK]
        scale = meta.skip_scale if l + 1 == meta.skip else 1.0
        h = hand_on(acc, scale)
        if l + 1 == meta.skip < meta.n_hidden:
            h[:, meta.pe_col:meta.pe_col + meta.d_pe] = pe_hand_on(pe, scale)
    n = meta.n_hidden
    sdf = h @ vec[n * W:(n + 1) * W] + vec[-1]
    if meta.skip == n:
        sdf = sdf + pe_hand_on(pe, meta.skip_scale) \
            @ vec[(n + 1) * W:(n + 1) * W + meta.d_pe]
    if bounding_sphere > 0.0:
        r_ = torch.linalg.norm(pts, dim=-1)
        sdf = torch.minimum(sdf, cfg.implicit.sphere_scale
                            * (bounding_sphere - r_))
    return sdf


@pytest.mark.parametrize("activation", ["float32", "bfloat16"])
@pytest.mark.parametrize("dims,skip_in,multires,bounding_sphere", FAMILY)
def test_bf16_kernel_emulation_matches_plain(dims, skip_in, multires,
                                             bounding_sphere, activation):
    """The bfloat16 mode read from its pack agrees with its plain version
    within 2^-8 (|want| + 1) on the 700 points."""
    cfg = _bf16_cfg(dims, skip_in, multires, activation)
    params = tinit(torch.Generator().manual_seed(0), cfg.model)
    pts = torch.tensor(np.random.default_rng(1).normal(size=(700, 3)),
                       dtype=torch.float32)
    pts[::7] *= 2.5
    pack = fused_sdf.pack_sdf(params.sdf, cfg.model)
    want = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts,
                                      bounding_sphere)
    with torch.no_grad():
        got = emulate_bf16_kernel(pack, cfg.model, pts, bounding_sphere)
    err = (got - want).abs()
    print(f"emulated bf16 kernel vs plain, dims {dims}, activations "
          f"{activation}: max|diff| {err.max().item():.3e}")
    assert torch.all(err <= 2.0 ** -8 * (want.abs() + 1)), err.max()
    assert err.max() > 0.0   # another accumulation order: live


@pytest.mark.parametrize("activation", ["float32", "bfloat16"])
def test_bf16_pack_layout(activation):
    """The bfloat16 pack: its mode recorded; one stage per K chunk
    holding W_hi = bf16(W) (rounded to nearest, no 1/sqrt(2) fold);
    the SDF column rounded to bf16; the junction's scale in the meta
    (bf16(1/sqrt(2)) with bf16 activations); a pack of the other mode is
    refused."""
    cfg = _bf16_cfg((256,) * 8, (4,), 6, activation)
    params = tinit(torch.Generator().manual_seed(0), cfg.model)
    pack = fused_sdf.pack_sdf(params.sdf, cfg.model)
    meta = pack.meta
    assert pack.mode == "bfloat16" and meta.mode == 1
    assert meta.act_bf16 == (activation == "bfloat16")
    assert meta.n_stages == 29 and tuple(pack.weights.shape) == (29, 256, 64)
    wb = fused_sdf.normalized_weights(params.sdf)
    for l, (w_hi, (w, _)) in enumerate(zip(_bf16_pack_layers(pack), wb)):
        k, n = w.shape
        torch.testing.assert_close(w_hi[:n, :k], w.T.to(torch.bfloat16),
                                   rtol=0, atol=0)
        assert torch.all(w_hi[n:] == 0) and torch.all(w_hi[:, k:] == 0)
    torch.testing.assert_close(pack.vec[8 * 256:9 * 256],
                               fused_sdf.bf16r(wb[8][0][:, 0]), rtol=0,
                               atol=0)
    scale = 0.70703125 if activation == "bfloat16" else fused_sdf.INV_SQRT2
    assert meta.skip_scale == pytest.approx(scale, rel=1e-7)
    f32 = fused_sdf.pack_sdf(params.sdf, tconfig.dtu_config().model)
    assert f32.mode == "float32" and f32.meta.n_stages == 58
    pts = torch.zeros((4, 3))
    with pytest.raises(ValueError, match="pack"):
        fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0, pack=f32)
    with pytest.raises(ValueError, match="pack"):
        fused_sdf.fused_sdf_values(params.sdf, tconfig.dtu_config().model,
                                   pts, 3.0, pack=pack)


def test_pack_once_per_weight_version(monkeypatch):
    """On the kernel's route, a training step packs once; after its
    optimizer step the next pack differs; a whole render, over several
    chunks, packs once. The route is the card's (`network.uses_kernel`);
    forced here, the CPU's sweeps still take the plain version and leave
    the pack unused. On the CPU's own route nothing is packed."""
    from s_volsdf_tpu_torch.models import network
    cfg = shrink(chip_smoke.float32_dtu_config())
    trainer = chip_smoke.make_trainer(cfg, IMG_RES, VOL, "cpu")
    sdf = trainer.state.params.sdf
    builds, sweeps = fused_sdf.pack_sdf.builds, fused_sdf.plain_sweeps
    trainer.run(1)
    assert fused_sdf.pack_sdf.builds == builds
    assert fused_sdf.plain_sweeps > sweeps
    monkeypatch.setattr(network, "uses_kernel", lambda params, cfg: True)
    before = fused_sdf.pack_sdf(sdf, cfg.model)
    builds = fused_sdf.pack_sdf.builds
    trainer.run(1)
    assert fused_sdf.pack_sdf.builds == builds + 1
    after = fused_sdf.pack_sdf(sdf, cfg.model)
    assert not torch.equal(before.weights, after.weights)
    assert not torch.equal(before.vec, after.vec)
    builds = fused_sdf.pack_sdf.builds
    trainer.render_mvs(0, res_scale=0.5, chunk=64)   # 6 chunks of 64 rays
    assert fused_sdf.pack_sdf.builds == builds + 1
