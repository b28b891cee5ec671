"""Modulated deformable convolution (DCNv2), stride 1, 3x3, padding 1:
the CUDA kernel `csrc/deform_conv.cu` and its plain PyTorch version
(counterpart of s_volsdf_tpu/ops/deform_conv.py:29-73, which the JAX
package leaves to XLA; the reference calls torchvision's kernel).

For each output pixel and each of the 9 taps, x is sampled bilinearly at
pixel + tap + (dy, dx) (a corner outside the image contributes 0), the
sample is scaled by the tap's mask, and the taps' samples are contracted
with the (9 * Cin, Cout) tap-major weight; then the bias is added.

Layouts are channel-major: x (Cin, H, W); offset (18, H, W), channel 2k
the tap's dy and 2k + 1 its dx (torchvision's reading of the offset
conv's first 18 channels); mask (9, H, W); out (Cout, H, W). The batched
entry point takes the same with a leading N.

Dispatch is by the device of x alone. CPU tensors go through
`deform_conv2d_plain`; CUDA tensors launch the kernel (one launch per
call, single image or batch, counted in `deform_conv2d.launches`) or
raise: the kernel takes contiguous float32 tensors, Cin 32
(TransMVSNet's every DCN) and Cout in {8, 16, 32}. There is no fallback
from the kernel to the plain version, and no gradient: the MVS nets are
frozen. The kernel library is built with nvcc at first use into
`_build/` and bound with ctypes.

The kernel's launch geometry is stated here (TILE, HALO, `smem_bytes`)
and handed to it, which refuses a launch whose geometry is not its own:
a block owns a TILE x TILE output tile and holds two input windows of
(TILE + 2 HALO)^2 pixels and the split weights in shared memory.
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
TILE, HALO = 16, 4         # the kernel's output tile and window margin


def smem_bytes(cout: int) -> int:
    """A block's shared memory: two float32 windows of (TILE + 2 HALO)^2
    pixels x 32 channels, and the weight split into TF32 hi and lo."""
    window = (TILE + 2 * HALO) ** 2 * KERNEL_CIN
    return 4 * (2 * window + TAPS * KERNEL_CIN * cout * 2)


def outside_window_share(offset: torch.Tensor) -> float:
    """The share of samples (pixel, tap) whose four corners do not all
    lie in their tile's window, which the kernel then reads from device
    memory: offset (18, H, W) or (N, 18, H, W)."""
    off = offset.reshape(-1, 2 * TAPS, *offset.shape[-2:])
    H, W = off.shape[-2:]
    dev = off.device
    ys = torch.arange(H, device=dev, dtype=off.dtype)[:, None]
    xs = torch.arange(W, device=dev, dtype=off.dtype)[None, :]
    lim = TILE + 2 * HALO - 2          # the last corner row / column
    out = 0
    for k in range(TAPS):
        ky, kx = divmod(k, 3)
        ry = (torch.floor(ys + (ky - 1) + off[:, 2 * k])
              - (torch.div(ys, TILE, rounding_mode="floor") * TILE - HALO))
        rx = (torch.floor(xs + (kx - 1) + off[:, 2 * k + 1])
              - (torch.div(xs, TILE, rounding_mode="floor") * TILE - HALO))
        inside = (ry >= 0) & (ry <= lim) & (rx >= 0) & (rx <= lim)
        out += int((~inside).sum().item())
    return out / (off.shape[0] * TAPS * H * W)


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
    w_taps = weight.reshape(TAPS, Cin, Cout)
    acc = torch.zeros((Cout, H * W), dtype=x.dtype, device=x.device)
    for k in range(TAPS):
        acc = acc + w_taps[k].T @ tap_samples(x, offset, mask, k)
    out = acc.reshape(Cout, H, W)
    if bias is not None:
        out = out + bias[:, None, None]
    return out


def tap_samples(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                k: int) -> torch.Tensor:
    """Tap k's masked bilinear samples of x (Cin, H, W) at every pixel,
    (Cin, H * W): the operand the plain version contracts with the
    tap's weight rows."""
    Cin, H, W = x.shape
    flat = x.reshape(Cin, H * W)
    dev, dt = x.device, x.dtype
    base_y = torch.arange(H, dtype=dt, device=dev)[:, None].expand(H, W)
    base_x = torch.arange(W, dtype=dt, device=dev)[None, :].expand(H, W)
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
    return v * mask[k].reshape(1, -1)


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
    lib.deform_conv2d_launch.argtypes = [vp] * 6 + [ci] * 7 + [
        ctypes.c_longlong, vp]
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
    N, Cin, H, W = x.shape
    want = {"x": (N, Cin, H, W), "offset": (N, 2 * TAPS, H, W),
            "mask": (N, TAPS, H, W),
            "weight": (TAPS * Cin, weight.shape[-1])}
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


def _launch(x, offset, mask, weight, bias) -> torch.Tensor:
    """One launch of the kernel on a checked batch, on the current
    stream."""
    _check_cuda(x, offset, mask, weight, bias)
    lib = _load()
    N, Cin, H, W = x.shape
    Cout = weight.shape[-1]
    out = torch.empty((N, Cout, H, W), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.deform_conv2d_launch(
        x.data_ptr(), offset.data_ptr(), mask.data_ptr(), weight.data_ptr(),
        None if bias is None else bias.data_ptr(), out.data_ptr(), N, Cin,
        Cout, H, W, TILE, HALO, smem_bytes(Cout), stream)
    if rc != 0:
        raise RuntimeError("deform_conv2d kernel launch failed: "
                           + lib.deform_conv2d_error_string(rc).decode())
    deform_conv2d.launches += 1
    return out


def _device_of(x: torch.Tensor) -> str:
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"deform_conv2d: unsupported device {x.device}")
    return x.device.type


def deform_conv2d(x: torch.Tensor, offset: torch.Tensor, mask: torch.Tensor,
                  weight: torch.Tensor,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(Cout, H, W) deformable conv of one image x (Cin, H, W) (module
    docstring). CPU tensors: `deform_conv2d_plain`. CUDA tensors: one
    launch of the kernel on the current stream, or an exception."""
    if _device_of(x) == "cpu":
        return deform_conv2d_plain(x, offset, mask, weight, bias)
    if x.dim() != 3:
        raise ValueError(f"deform_conv2d: want x (Cin, H, W), got "
                         f"{tuple(x.shape)}")
    return _launch(x[None], offset[None], mask[None], weight, bias)[0]


deform_conv2d.launches = 0


def deform_conv2d_batch(x: torch.Tensor, offset: torch.Tensor,
                        mask: torch.Tensor, weight: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(N, Cout, H, W) deformable convs of the images x (N, Cin, H, W),
    offset (N, 18, H, W), mask (N, 9, H, W), one weight. CPU tensors:
    `deform_conv2d_plain` per image. CUDA tensors: one launch for the
    whole batch (counted in `deform_conv2d.launches`), or an
    exception."""
    if _device_of(x) == "cpu":
        return torch.stack([deform_conv2d_plain(x[n], offset[n], mask[n],
                                                weight, bias)
                            for n in range(x.shape[0])])
    if x.dim() != 4:
        raise ValueError(f"deform_conv2d_batch: want x (N, Cin, H, W), got "
                         f"{tuple(x.shape)}")
    return _launch(x, offset, mask, weight, bias)


def flops(H: int, W: int, cin: int, cout: int) -> int:
    """The operations a launch does on the FP32 pipe when it contracts
    there, as the first design did: per pixel, tap and input channel the
    four corners' multiply-adds and the contraction's Cout, two flops
    each (the FP32-pipe bound PERF.md keeps beside the new one)."""
    return 2 * H * W * TAPS * cin * (4 + cout)


def tensor_flops(H: int, W: int, cin: int, cout: int) -> int:
    """The contraction at float32 accuracy on the tensor cores: three
    TF32 products (hi*hi, hi*lo, lo*hi) of the (HW, 9 Cin) x (9 Cin,
    Cout) GEMM, two flops a multiply-add."""
    return 3 * 2 * H * W * TAPS * cin * cout


def blend_flops(H: int, W: int, cin: int) -> int:
    """The corner blend on the FP32 pipe: four multiply-adds per pixel,
    tap and input channel."""
    return 2 * H * W * TAPS * cin * 4


def io_bytes(H: int, W: int, cin: int, cout: int) -> int:
    """The bytes a launch must move: x, the offsets and the mask read
    once, the output written once (float32); the weight and bias are
    negligible."""
    return 4 * H * W * (cin + 3 * TAPS + cout)
