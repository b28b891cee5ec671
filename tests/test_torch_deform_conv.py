"""The port's deformable conv (s_volsdf_tpu_torch/ops/deform_conv.py)
against the JAX package's (s_volsdf_tpu/ops/deform_conv.py), on the CPU,
where the wrapper takes its plain version; the CUDA kernel is held to
the plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).

Inputs are unit-scale, made with numpy from a seed: x normal, offsets
normal with a 3-pixel spread (samples past every edge of the image),
masks uniform in (0, 1), the (9 Cin, Cout) weight uniform in
+-1/sqrt(9 Cin). Bar: 1e-5 absolute, float32 sums of 288 products (and
each sample's four corners) in another order than XLA's.

The kernel's arithmetic, three TF32 products a multiply-add, is
emulated here in torch and held to the plain version at the kernel's
bar (chip_smoke.DCN_TOL); its launch geometry is checked against the
card's shared memory.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from s_volsdf_tpu.ops.deform_conv import deform_conv2d as jdeform_conv2d
from s_volsdf_tpu_torch.ops import deform_conv as D

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

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
    """The operations and bytes chip_smoke.py's bounds count at the
    largest launch of TransMVSNet (1152x1536, 32 -> 32). The tensor-core
    bound: three TF32 products of the (HW, 288) x (288, 32) GEMM, 3 x
    32.6 GFLOP, 0.198 ms at 495 TFLOP/s; the corner blend 4.08 GFLOP on
    the FP32 pipe. The FP32-pipe bound of the first design: per pixel 9
    x 32 x (4 + 32) multiply-adds, 18.3 G. Bytes: x, 27 offset and mask
    channels and the output once, 0.64 GB."""
    n = 1152 * 1536
    assert D.tensor_flops(1152, 1536, 32, 32) == 3 * 2 * n * 288 * 32
    assert abs(D.tensor_flops(1152, 1536, 32, 32) / 3 / 1e9 - 32.6) < 0.05
    tensor_ms = D.tensor_flops(1152, 1536, 32, 32) / 495e12 * 1e3
    assert abs(tensor_ms - 0.198) < 0.001
    assert D.blend_flops(1152, 1536, 32) == 2 * n * 288 * 4
    assert abs(D.blend_flops(1152, 1536, 32) / 1e9 - 4.08) < 0.01
    assert D.flops(1152, 1536, 32, 32) == 2 * n * 288 * 36
    assert abs(D.flops(1152, 1536, 32, 32) / 2 / 1e9 - 18.35) < 0.01
    assert D.io_bytes(1152, 1536, 32, 32) == 4 * n * (32 + 27 + 32)
    assert abs(D.io_bytes(1152, 1536, 32, 32) / 1e9 - 0.644) < 0.001
    bytes_ms = D.io_bytes(1152, 1536, 32, 32) / 3.35e12 * 1e3
    assert tensor_ms > bytes_ms        # the tensor cores bound 32 -> 32
    assert (D.tensor_flops(1152, 1536, 32, 8) / 495e12
            < D.io_bytes(1152, 1536, 32, 8) / 3.35e12)   # bytes: 32 -> 8


@pytest.mark.parametrize("cout", D.KERNEL_COUTS)
def test_launch_geometry_fits_shared_memory(cout):
    """Two (16 + 2 x 4)^2-pixel windows of 32 float32 channels and the
    weight split in hi and lo fit a block's 232,448 bytes at every Cout
    the kernel takes (221,184 at Cout 32)."""
    window = (D.TILE + 2 * D.HALO) ** 2 * D.KERNEL_CIN * 4
    assert D.smem_bytes(cout) == 2 * window + D.TAPS * 32 * cout * 8
    assert D.smem_bytes(cout) <= 232448     # a Hopper block's maximum
    assert D.smem_bytes(32) == 221184


def _tf32_rna(a):
    """a rounded to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32: add half a unit to the magnitude's
    bits and clear the 13 low ones."""
    return ((a.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(a):
    """a as the tensor core reads a float32 operand in TF32: its 13 low
    mantissa bits ignored."""
    return (a.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_conv(x, offset, mask, weight, bias, passes):
    """The plain version with its contraction in the kernel's TF32
    arithmetic: samples and weights split into hi = rna(a) and lo = a -
    hi (lo read truncated by the tensor core); `passes` 3 accumulates
    lo*W_hi + hi*W_lo + hi*W_hi in float32, 1 only hi*W_hi (a single
    TF32 product)."""
    Cin, H, W = x.shape
    Cout = weight.shape[-1]
    w_taps = weight.reshape(D.TAPS, Cin, Cout)
    acc = torch.zeros((Cout, H * W))
    for k in range(D.TAPS):
        v = D.tap_samples(x, offset, mask, k)
        v_hi, w_hi = _tf32_rna(v), _tf32_rna(w_taps[k])
        if passes == 3:
            v_lo, w_lo = _tf32_trunc(v - v_hi), _tf32_trunc(w_taps[k] - w_hi)
            acc = acc + w_hi.T @ v_lo + w_lo.T @ v_hi
        acc = acc + w_hi.T @ v_hi
    return acc.reshape(Cout, H, W) + bias[:, None, None]


def test_tf32_rounding_helpers():
    """rna keeps 10 mantissa bits, rounds half away from zero, and hi +
    lo is the value exactly."""
    a = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11),
                      1.0 + 2.0 ** -12, 3.0 + 2.0 ** -20])
    hi = _tf32_rna(a)
    assert hi.tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    assert torch.equal(hi + (a - hi), a)
    assert _tf32_trunc(torch.tensor([1.0 + 2.0 ** -11])).item() == 1.0


@pytest.mark.parametrize("cout", D.KERNEL_COUTS)
def test_three_tf32_products_meet_the_bar(cout):
    """On chip_smoke's inputs (offsets with a 2-pixel spread, masks in
    (0, 1)) the kernel's three TF32 products stay within DCN_TOL (1 +
    |plain|) of the plain float32 version; a single TF32 product does
    not, so the bar tells the two apart."""
    args = chip_smoke.dcn_inputs(H, W, cout, "cpu", cout)
    ref = D.deform_conv2d_plain(*args)

    def rel(got):
        return ((got - ref) / (1 + ref.abs())).abs().max().item()

    three, one = rel(_split_conv(*args, passes=3)), rel(_split_conv(*args, 1))
    assert three <= chip_smoke.DCN_TOL, three
    assert one > chip_smoke.DCN_TOL, one
    assert three < one / 20


def test_batch_on_cpu_is_the_plain_version_per_image():
    """deform_conv2d_batch on CPU tensors: each image's plain deformable
    conv, stacked; no launch."""
    views = [chip_smoke.dcn_inputs(H, W, 16, "cpu", 40 + v) for v in range(3)]
    x, offset, mask = (torch.stack([v[i] for v in views]) for i in range(3))
    weight, bias = views[0][3], views[0][4]
    launches = D.deform_conv2d.launches
    got = D.deform_conv2d_batch(x, offset, mask, weight, bias)
    assert got.shape == (3, 16, H, W)
    for v in range(3):
        assert torch.equal(got[v], D.deform_conv2d_plain(
            x[v], offset[v], mask[v], weight, bias))
    assert D.deform_conv2d.launches == launches


def test_outside_window_share_counts_samples():
    """The share of samples whose corners leave the window, against a
    count sample by sample: zero offsets stay inside (the halo is wider
    than a tap's reach), and a 2-pixel spread leaves about 1%."""
    assert D.outside_window_share(torch.zeros(2 * D.TAPS, 20, 33)) == 0.0
    rng = np.random.default_rng(3)
    Hs, Ws = 20, 33
    off = (2.0 * rng.standard_normal((2 * D.TAPS, Hs, Ws))).astype(
        np.float32)
    lim = D.TILE + 2 * D.HALO - 2
    out = 0
    for k in range(D.TAPS):
        for y in range(Hs):
            for x in range(Ws):
                fy = np.floor(np.float32(y + k // 3 - 1) + off[2 * k, y, x])
                fx = np.floor(np.float32(x + k % 3 - 1)
                              + off[2 * k + 1, y, x])
                ry = fy - (y // D.TILE * D.TILE - D.HALO)
                rx = fx - (x // D.TILE * D.TILE - D.HALO)
                out += not (0 <= ry <= lim and 0 <= rx <= lim)
    share = D.outside_window_share(torch.tensor(off))
    assert share == out / (D.TAPS * Hs * Ws)
    assert 0.002 < share < 0.05
    batch = torch.tensor(off)[None].expand(2, -1, -1, -1)
    assert D.outside_window_share(batch) == share


def test_meta_device_refused():
    """Only CPU and CUDA tensors are taken."""
    t = torch.empty((CIN, H, W), device="meta")
    with pytest.raises(ValueError, match="device"):
        D.deform_conv2d(t, t, t, t)
