"""The port's fused-SDF wrapper on the CPU (its plain PyTorch version)
against the JAX package's Pallas kernel in interpret mode and against
JAX `sdf_values`, at the full dtu width (8x256, skip at 4, multires 6)
on 700 points (a ragged tail for the kernel's tiles).

Tolerance 3e-5 absolute, the bar tests/test_pallas_fused_sdf.py holds
the Pallas kernel to: float32 sums in another order across 9 layers.
The kernel itself runs only on a card (tests/test_torch_cuda.py and
chip_smoke.py).
"""

import jax
import numpy as np
import torch

from s_volsdf_tpu.config import load_config
from s_volsdf_tpu.models.network import init_volsdf_params, sdf_values
from s_volsdf_tpu.ops.pallas.fused_sdf import fused_sdf_values as jax_fused
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.bridge import from_jax_params
from s_volsdf_tpu_torch.models.network import sdf_values as tsdf_values
from s_volsdf_tpu_torch.ops import fused_sdf


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


def test_supported_family():
    cfg = tconfig.dtu_config()
    assert fused_sdf.supported(cfg.model)
    cfg.model.implicit.skip_in = (2, 4)
    assert not fused_sdf.supported(cfg.model)
    cfg = tconfig.dtu_config()
    cfg.model.implicit.dims = (512,) * 8
    assert not fused_sdf.supported(cfg.model)


def test_packed_layout_matches_weights():
    """The kernel's packed buffer holds each layer's materialised weights
    (rows padded to 4 with zeros) and the last layer's SDF column."""
    cfg = tconfig.dtu_config()
    from s_volsdf_tpu_torch.models.network import init_volsdf_params as tinit
    params = tinit(torch.Generator().manual_seed(0), cfg.model)
    packed, meta = fused_sdf._pack_params(params.sdf, cfg.model, 3.0, "cpu")
    wb = fused_sdf.normalized_weights(params.sdf)
    assert meta.n_layers == 9 and meta.skip_layer == 4 and meta.d_pe == 39
    assert list(meta.in_dim)[:9] == [39, 256, 256, 256, 256, 256, 256, 256, 256]
    assert list(meta.in_pad)[:9] == [40] + [256] * 8
    assert list(meta.out)[:9] == [256, 256, 256, 217, 256, 256, 256, 256, 1]
    for l, (w, b) in enumerate(wb):
        if l == 8:
            w, b = w[:, :1], b[:1]
        d_in, d_out = w.shape
        got_w = packed[meta.w_off[l]:meta.b_off[l]].reshape(meta.in_pad[l], d_out)
        torch.testing.assert_close(got_w[:d_in], w, rtol=0, atol=0)
        assert torch.all(got_w[d_in:] == 0)
        torch.testing.assert_close(
            packed[meta.b_off[l]:meta.b_off[l] + d_out], b, rtol=0, atol=0)
    assert packed.numel() == meta.b_off[8] + 1
