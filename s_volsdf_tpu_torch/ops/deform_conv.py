"""Modulated deformable convolution (DCNv2), stride 1, 3x3, padding 1:
the CUDA kernel `csrc/deform_conv.cu` and its plain PyTorch version
(counterpart of s_volsdf_tpu/ops/deform_conv.py:29-73, which the JAX
package leaves to XLA; the reference calls torchvision's kernel).

For each output pixel and each of the 9 taps, x is sampled bilinearly at
pixel + tap + (dy, dx) (a corner outside the image contributes 0), the
sample is scaled by the tap's mask, and the taps' samples are contracted
with the (9 * Cin, Cout) tap-major weight; then the bias is added.

Layouts are channel-major, one image: x (Cin, H, W); offset (18, H, W),
channel 2k the tap's dy and 2k + 1 its dx (torchvision's reading of the
offset conv's first 18 channels); mask (9, H, W); out (Cout, H, W).

Dispatch is by the device of x alone. CPU tensors go through
`deform_conv2d_plain`; CUDA tensors launch the kernel (one launch per
call, counted in `deform_conv2d.launches`) or raise: the kernel takes
contiguous float32 tensors, Cin 32 (TransMVSNet's every DCN) and Cout in
{8, 16, 32}, and a scratch channel-last copy of x that the wrapper
allocates. There is no fallback from the kernel to the plain version,
and no gradient: the MVS nets are frozen. The kernel library is built
with nvcc at first use into `_build/` and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import torch

from s_volsdf_tpu_torch.ops.build import (CSRC_DIR, NVCC_FLAGS,
                                          build_library, nvcc)

SOURCE = os.path.join(CSRC_DIR, "deform_conv.cu")
TAPS = 9
KERNEL_CIN, KERNEL_COUTS = 32, (8, 16, 32)


def deform_conv2d_plain(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """What the kernel computes, as JAX's per-tap gather and matmul: the
    four corners of each sample gathered by flat index (an index outside
    the image reads pixel 0 with weight 0), summed in the order (0, 0),
    (0, 1), (1, 0), (1, 1) as (y, x), masked, and contracted with the
    tap's weight rows into an accumulator that starts at 0."""
    Cin, H, W = x.shape
    Cout = weight.shape[-1]
    flat = x.reshape(Cin, H * W)
    dev, dt = x.device, x.dtype
    base_y = torch.arange(H, dtype=dt, device=dev)[:, None].expand(H, W)
    base_x = torch.arange(W, dtype=dt, device=dev)[None, :].expand(H, W)
    w_taps = weight.reshape(TAPS, Cin, Cout)
    acc = torch.zeros((Cout, H * W), dtype=dt, device=dev)
    for k in range(TAPS):
        ky, kx = divmod(k, 3)
        py = (base_y + (ky - 1)) + offset[2 * k]
        px = (base_x + (kx - 1)) + offset[2 * k + 1]
        y0, x0 = torch.floor(py), torch.floor(px)
        wy, wx = py - y0, px - x0
        v = torch.zeros((Cin, H * W), dtype=dt, device=dev)
        for cy, cx in ((0, 0), (0, 1), (1, 0), (1, 1)):
            yi, xi = y0 + cy, x0 + cx
            ok = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            idx = torch.where(ok, yi * W + xi, 0.0).to(torch.int64)
            w = (wx if cx else 1.0 - wx) * (wy if cy else 1.0 - wy)
            w = torch.where(ok, w, 0.0).reshape(-1)
            v = v + flat[:, idx.reshape(-1)] * w
        v = v * mask[k].reshape(1, -1)
        acc = acc + w_taps[k].T @ v
    out = acc.reshape(Cout, H, W)
    if bias is not None:
        out = out + bias[:, None, None]
    return out


_LIB = None
_LIB_LOCK = threading.Lock()


def build(force: bool = False) -> str:
    """Compile csrc/deform_conv.cu into _build/libdeform_conv.so unless an
    up-to-date library exists. Raises RuntimeError naming nvcc when it
    cannot."""
    return build_library([nvcc()] + NVCC_FLAGS, SOURCE, "libdeform_conv.so",
                         force)


def bind(path: str):
    """Load a build of csrc/deform_conv.cu and declare its C entry
    points."""
    lib = ctypes.CDLL(path)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.deform_conv2d_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                         ci, ci, vp]
    lib.deform_conv2d_launch.restype = ci
    lib.deform_conv2d_error_string.argtypes = [ci]
    lib.deform_conv2d_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = bind(build())
        return _LIB


def _check_cuda(x, offset, mask, weight, bias) -> None:
    Cin, H, W = x.shape
    want = {"x": (Cin, H, W), "offset": (2 * TAPS, H, W),
            "mask": (TAPS, H, W), "weight": (TAPS * Cin, weight.shape[-1])}
    tensors = {"x": x, "offset": offset, "mask": mask, "weight": weight}
    if bias is not None:
        want["bias"] = (weight.shape[-1],)
        tensors["bias"] = bias
    for name, t in tensors.items():
        if t.device != x.device:
            raise ValueError(f"deform_conv2d: {name} on {t.device}, x on "
                             f"{x.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"deform_conv2d: the kernel takes float32, "
                             f"{name} is {t.dtype}")
        if tuple(t.shape) != want[name] or not t.is_contiguous():
            raise ValueError(f"deform_conv2d: {name} must be contiguous "
                             f"{want[name]}, got {tuple(t.shape)}")
    Cout = weight.shape[-1]
    if Cout not in KERNEL_COUTS or Cin != KERNEL_CIN:
        raise ValueError(f"deform_conv2d: the kernel takes Cin "
                         f"{KERNEL_CIN} and Cout in {KERNEL_COUTS}, got "
                         f"{Cin} -> {Cout}")
    if KERNEL_CIN * H * W >= 2 ** 31:
        raise ValueError(f"deform_conv2d: {H}x{W} exceeds int32 indexing")


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Cout, H, W) deformable conv of x (Cin, H, W) (module docstring).
    CPU tensors: `deform_conv2d_plain`. CUDA tensors: one launch of the
    kernel on the current stream, or an exception."""
    if x.device.type == "cpu":
        return deform_conv2d_plain(x, offset, mask, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"deform_conv2d: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"deform_conv2d: want x (Cin, H, W), got "
                         f"{tuple(x.shape)}")
    _check_cuda(x, offset, mask, weight, bias)
    lib = _load()
    Cin, H, W = x.shape
    Cout = weight.shape[-1]
    out = torch.empty((Cout, H, W), dtype=torch.float32, device=x.device)
    x_hwc = torch.empty((H, W, Cin), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.deform_conv2d_launch(
        x.data_ptr(), x_hwc.data_ptr(), offset.data_ptr(), mask.data_ptr(),
        weight.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), Cin, Cout, H, W, stream)
    if rc != 0:
        raise RuntimeError("deform_conv2d kernel launch failed: "
                           + lib.deform_conv2d_error_string(rc).decode())
    deform_conv2d.launches += 1
    return out


deform_conv2d.launches = 0


def flops(H: int, W: int, cin: int, cout: int) -> int:
    """The operations a launch must do: per pixel, tap and input channel
    the four corners' multiply-adds and the contraction's Cout, two
    flops each."""
    return 2 * H * W * TAPS * cin * (4 + cout)


def io_bytes(H: int, W: int, cin: int, cout: int) -> int:
    """The bytes a launch must move: x, the offsets and the mask read
    once, the output written once (float32); the weight and bias are
    negligible."""
    return 4 * H * W * (cin + 3 * TAPS + cout)
