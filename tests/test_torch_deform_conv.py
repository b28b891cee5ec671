"""The port's deformable conv (s_volsdf_tpu_torch/ops/deform_conv.py)
against the JAX package's (s_volsdf_tpu/ops/deform_conv.py), on the CPU,
where the wrapper takes its plain version; the CUDA kernel is held to
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Inputs are unit-scale, made with numpy from a seed: x normal, offsets
normal with a 3-pixel spread (samples past every edge of the image),
masks uniform in (0, 1), the (9 Cin, Cout) weight uniform in
+-1/sqrt(9 Cin). Bar: 1e-5 absolute, float32 sums of 288 products (and
each sample's four corners) in another order than XLA's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s_volsdf_tpu.ops.deform_conv import deform_conv2d as jdeform_conv2d
from s_volsdf_tpu_torch.ops import deform_conv as D

ATOL = 1e-5
H, W, CIN = 12, 17, 32


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(cout, seed, spread=3.0):
    rng = np.random.default_rng(seed)
    K = D.TAPS
    x = rng.standard_normal((H, W, CIN)).astype(np.float32)
    offset = (spread * rng.standard_normal((H, W, 2 * K))).astype(np.float32)
    mask = rng.uniform(0, 1, (H, W, K)).astype(np.float32)
    bound = 1.0 / np.sqrt(K * CIN)
    w = rng.uniform(-bound, bound, (K * CIN, cout)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    return x, offset, mask, w, b


def _chw(a):
    return torch.tensor(a).permute(2, 0, 1).contiguous()


def _both(x, offset, mask, w, b):
    want = np.asarray(jdeform_conv2d(jnp.asarray(x), jnp.asarray(offset),
                                     jnp.asarray(mask), jnp.asarray(w),
                                     jnp.asarray(b)))
    got = D.deform_conv2d(_chw(x), _chw(offset), _chw(mask), torch.tensor(w),
                          torch.tensor(b))
    return got.permute(1, 2, 0).numpy(), want


@pytest.mark.parametrize("cout", [8, 16, 32])
def test_plain_matches_jax(cout):
    x, offset, mask, w, b = _inputs(cout, seed=cout)
    # The samples leave the image on every side.
    ys = np.arange(H)[:, None, None] + offset[..., 0::2]
    xs = np.arange(W)[None, :, None] + offset[..., 1::2]
    assert ys.min() < -1 and ys.max() > H and xs.min() < -1 and xs.max() > W
    launches = D.deform_conv2d.launches
    got, want = _both(x, offset, mask, w, b)
    assert got.shape == (H, W, cout)
    np.testing.assert_allclose(got, want, atol=ATOL)
    assert D.deform_conv2d.launches == launches     # the CPU's plain version


def test_zero_offsets_are_a_conv():
    """Zero offsets and a unit mask: a 3x3 conv with zero padding."""
    x, offset, mask, w, b = _inputs(16, seed=1)
    offset[:] = 0.0
    mask[:] = 1.0
    got, want = _both(x, offset, mask, w, b)
    kernel = torch.tensor(w).reshape(3, 3, CIN, 16).permute(3, 2, 0, 1)
    conv = F.conv2d(_chw(x)[None], kernel, torch.tensor(b), padding=1)[0]
    np.testing.assert_allclose(got, conv.permute(1, 2, 0).numpy(), atol=ATOL)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_offsets_read_as_dy_dx_pairs():
    """Channel 2k moves tap k along y, channel 2k + 1 along x: a whole
    pixel down is the conv of the image shifted up by one row (below
    the first output row, whose upper taps read row 0 and not the
    padding)."""
    x, offset, mask, w, b = _inputs(8, seed=2)
    offset[:] = 0.0
    offset[..., 0::2] = 1.0
    mask[:] = 1.0
    got, want = _both(x, offset, mask, w, b)
    shifted = np.concatenate([x[1:], np.zeros_like(x[:1])])
    ref, _ = _both(shifted, np.zeros_like(offset), mask, w, b)
    np.testing.assert_allclose(got[1:], ref[1:], atol=ATOL)
    assert np.abs(got[0] - ref[0]).max() > 0.1
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_bound_arithmetic():
    """The operations and bytes chip_smoke.py's bound counts at the
    largest launch of TransMVSNet (1152x1536, 32 -> 32): per pixel 9 x 32
    x (4 + 32) multiply-adds, 18.3 G; x, 27 offset and mask channels and
    the output once, 0.64 GB."""
    n = 1152 * 1536
    assert D.flops(1152, 1536, 32, 32) == 2 * n * 288 * 36
    assert abs(D.flops(1152, 1536, 32, 32) / 2 / 1e9 - 18.35) < 0.01
    assert D.io_bytes(1152, 1536, 32, 32) == 4 * n * (32 + 27 + 32)
    assert abs(D.io_bytes(1152, 1536, 32, 32) / 1e9 - 0.644) < 0.001


def test_meta_device_refused():
    """Only CPU and CUDA tensors are taken."""
    t = torch.empty((CIN, H, W), device="meta")
    with pytest.raises(ValueError, match="device"):
        D.deform_conv2d(t, t, t, t)
