"""Fused no-grad SDF-MLP forward: the CUDA kernel `csrc/fused_sdf.cu`
and its plain PyTorch version (counterpart of
s_volsdf_tpu/ops/pallas/fused_sdf.py).

`fused_sdf_values` is the sampler's SDF sweep in the port: the R x 128
points per sampler iteration in training (models/network.py) and every
sweep of the depth render (engine/render.py). It needs no gradient: the
sweep runs under `torch.no_grad()` on detached parameters, as JAX
applies `stop_gradient` there.

Dispatch is by the device of `pts` alone. A CPU tensor goes through
`sdf_values_plain`; a CUDA tensor launches the kernel or raises (a
config outside `supported`, a failed build, a refused launch). There is
no fallback from the kernel to the plain version.

The kernel library is built with nvcc at first use into `_build/`
(rebuilt when the source is newer) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from typing import List, Tuple

import torch

from s_volsdf_tpu_torch.config import ModelConfig
from s_volsdf_tpu_torch.models.embedder import embed_dim, positional_encoding
from s_volsdf_tpu_torch.models.layers import softplus_b

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "fused_sdf.cu")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
LIB_PATH = os.path.join(BUILD_DIR, "libfused_sdf.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

MAX_LAYERS = 16      # csrc/fused_sdf.cu MAX_LAYERS
MAX_WIDTH = 256      # csrc/fused_sdf.cu MAX_WIDTH
MAX_MULTIRES = 10    # PE_STRIDE = 64 columns


class SdfMeta(ctypes.Structure):
    """Mirror of `struct SdfMeta` in csrc/fused_sdf.cu (passed by value)."""
    _fields_ = [
        ("n_layers", ctypes.c_int),
        ("skip_layer", ctypes.c_int),
        ("multires", ctypes.c_int),
        ("d_pe", ctypes.c_int),
        ("bounding_sphere", ctypes.c_float),
        ("sphere_scale", ctypes.c_float),
        ("in_dim", ctypes.c_int * MAX_LAYERS),
        ("in_pad", ctypes.c_int * MAX_LAYERS),
        ("out", ctypes.c_int * MAX_LAYERS),
        ("w_off", ctypes.c_int * MAX_LAYERS),
        ("b_off", ctypes.c_int * MAX_LAYERS),
    ]


def supported(cfg: ModelConfig) -> bool:
    """The family the kernel covers: 3-D input with PE (multires <= 10),
    uniform hidden width <= 256, at most one skip junction, at most 16
    layers. Same family as the Pallas kernel's `supported`."""
    imp = cfg.implicit
    return (imp.d_in == 3 and 0 < imp.multires <= MAX_MULTIRES
            and len(set(imp.dims)) == 1 and imp.dims[0] <= MAX_WIDTH
            and len(imp.skip_in) <= 1
            and all(0 < s <= len(imp.dims) for s in imp.skip_in)
            and len(imp.dims) + 1 <= MAX_LAYERS)


def normalized_weights(sdf_params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Materialise every layer to a plain detached (W (in, out), b) pair."""
    return [(p.weight().detach(), p.b.detach()) for p in sdf_params]


def sdf_values_plain(sdf_params, cfg: ModelConfig, pts: torch.Tensor,
                     bounding_sphere: float) -> torch.Tensor:
    """What the kernel computes, as one torch.matmul per layer: the
    clamped SDF (N,) of pts (N, 3). The last layer is applied to its SDF
    column only. Softplus is `layers.softplus_b`'s jax.nn form."""
    imp = cfg.implicit
    with torch.no_grad():
        wb = normalized_weights(sdf_params)
        inp = positional_encoding(pts, imp.multires)
        h = inp
        inv_sqrt2 = 0.7071067811865475
        for l, (w, b) in enumerate(wb):
            if l in imp.skip_in:
                h = torch.cat([h, inp], dim=-1) * inv_sqrt2
            if l == len(wb) - 1:
                h = h @ w[:, :1] + b[:1]
            else:
                h = softplus_b(h @ w + b, beta=100.0)
        sdf = h[:, 0]
        if bounding_sphere > 0.0:
            r = torch.linalg.norm(pts, dim=-1)
            sdf = torch.minimum(sdf, imp.sphere_scale * (bounding_sphere - r))
        return sdf


def _pack_params(sdf_params, cfg: ModelConfig, bounding_sphere: float,
                 device) -> Tuple[torch.Tensor, SdfMeta]:
    """One contiguous f32 buffer of every layer's (W, b), rows padded to
    a multiple of 4 with zeros, the last layer as its SDF column only;
    plus the kernel's layer table."""
    imp = cfg.implicit
    wb = normalized_weights(sdf_params)
    meta = SdfMeta()
    meta.n_layers = len(wb)
    meta.skip_layer = imp.skip_in[0] if imp.skip_in else -1
    meta.multires = imp.multires
    meta.d_pe = embed_dim(imp.multires, imp.d_in)
    meta.bounding_sphere = float(bounding_sphere)
    meta.sphere_scale = float(imp.sphere_scale)
    chunks, off = [], 0
    for l, (w, b) in enumerate(wb):
        if l == len(wb) - 1:
            w, b = w[:, :1], b[:1]
        d_in, d_out = w.shape
        in_pad = -(-d_in // 4) * 4
        if in_pad > d_in:
            w = torch.cat([w, w.new_zeros((in_pad - d_in, d_out))], dim=0)
        meta.in_dim[l], meta.in_pad[l], meta.out[l] = d_in, in_pad, d_out
        meta.w_off[l] = off
        meta.b_off[l] = off + w.numel()
        off += w.numel() + b.numel()
        chunks += [w.reshape(-1), b.reshape(-1)]
    packed = torch.cat(chunks).to(device=device, dtype=torch.float32)
    return packed.contiguous(), meta


_LIB = None
_LIB_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the "
                           "fused SDF kernel cannot be built")
    return path


def build(force: bool = False) -> str:
    """Compile csrc/fused_sdf.cu into _build/libfused_sdf.so unless an
    up-to-date library exists. Written to a temporary name and renamed,
    so concurrent processes never load a partial file. Raises on failure."""
    if (not force and os.path.exists(LIB_PATH)
            and os.path.getmtime(LIB_PATH) >= os.path.getmtime(SOURCE)):
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB_PATH}.tmp.{os.getpid()}"
    cmd = [_nvcc()] + NVCC_FLAGS + ["-o", tmp, SOURCE]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({' '.join(cmd)}):\n{res.stderr}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build())
            lib.fused_sdf_forward.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_int, SdfMeta, ctypes.c_void_p]
            lib.fused_sdf_forward.restype = ctypes.c_int
            lib.fused_sdf_error_string.argtypes = [ctypes.c_int]
            lib.fused_sdf_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def fused_sdf_values(sdf_params, cfg: ModelConfig, pts: torch.Tensor,
                     bounding_sphere: float) -> torch.Tensor:
    """Clamped SDF values (N,) of pts (N, 3) f32, without gradient.

    CPU tensor: `sdf_values_plain`. CUDA tensor: one launch of the fused
    kernel on the current stream (counted in `fused_sdf_values.launches`),
    or an exception."""
    if pts.device.type == "cpu":
        return sdf_values_plain(sdf_params, cfg, pts, bounding_sphere)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_sdf_values: unsupported device {pts.device}")
    if not supported(cfg):
        raise ValueError(f"fused_sdf_values: config outside the kernel's "
                         f"family: {cfg.implicit}")
    if pts.dtype != torch.float32 or pts.dim() != 2 or pts.shape[1] != 3:
        raise ValueError(f"fused_sdf_values: want (N, 3) float32 points, "
                         f"got {tuple(pts.shape)} {pts.dtype}")
    if not pts.is_contiguous():
        raise ValueError("fused_sdf_values: points must be contiguous")
    n = pts.shape[0]
    if n >= 2 ** 31:
        raise ValueError(f"fused_sdf_values: {n} points exceed int32 indexing")
    lib = _load()
    with torch.no_grad():
        packed, meta = _pack_params(sdf_params, cfg, bounding_sphere,
                                    pts.device)
    out = torch.empty((n,), dtype=torch.float32, device=pts.device)
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    rc = lib.fused_sdf_forward(pts.data_ptr(), packed.data_ptr(),
                               out.data_ptr(), n, meta, stream)
    if rc != 0:
        raise RuntimeError("fused_sdf kernel launch failed: "
                           + lib.fused_sdf_error_string(rc).decode())
    fused_sdf_values.launches += 1
    return out


fused_sdf_values.launches = 0
