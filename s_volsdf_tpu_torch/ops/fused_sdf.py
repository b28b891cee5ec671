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

The kernel has two modes, named by the model config's precision (`mode`):
"float32" (compute_dtype float32) reproduces the float32 MLP with three
bf16 products per layer on the tensor cores (hi/lo split, f32
accumulation); "bfloat16" (compute_dtype bfloat16, the JAX training
step's default) is one bf16 product per layer, rounding where the JAX
bf16 MLP rounds (csrc/fused_sdf.cu's header); with bf16 activations its
softplus is a table of torch's bf16 ops over a band of bf16 inputs
(`act_bf16_table`, built once a process on each device and handed to
every launch) with closed forms outside it. `pack_sdf` lays the
weights out for one mode once per weight version, and the pack carries
its mode: the callers pack once per training step and once per render
(`models/network.sampler_sdf_fn`) and hand the pack to every launch;
`fused_sdf_values` without a pack packs for itself, and refuses a pack
of another mode than its config's. `fused_sdf_values` stays strict: a
config outside `supported` raises on the card; the sampler's sweep
chooses the plain route for such a config before any launch
(`models.network.sampler_sdf_fn`, counted in `plain_sweeps`), as the
JAX package's gate `supported` keeps its Pallas kernel to the family.

The scene axis (the lockstep multi-scene step, engine/multiscene.py):
with stacked SDF parameters (leaves with a leading S axis,
`models.layers`), `pack_sdf_scenes` stacks the S scenes' packs into one
(S, n_stages, 256, 64) stream and an (S, L) vector, and
`fused_sdf_values` takes points (S, N, 3) and returns (S, N) from ONE
launch: each block's `blockIdx.y` picks its scene's points, weight
stream and vector. A point's arithmetic is the single launch's, so the
batched launch equals S single launches bit for bit. The plain version
of stacked parameters loops over the scenes. `scene_launches` counts
every launch by its number of scenes (1 for a single launch).

The kernel library is built with nvcc at first use into `_build/`
(rebuilt when the source is newer) and bound with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading
from typing import List, Optional, Tuple

import numpy as np
import torch

from s_volsdf_tpu_torch.config import ModelConfig
from s_volsdf_tpu_torch.models.embedder import embed_dim, positional_encoding
from s_volsdf_tpu_torch.models.layers import n_scenes, softplus_b
from s_volsdf_tpu_torch.ops.build import (CSRC_DIR, NVCC_FLAGS,
                                          build_library, nvcc)

SOURCE = os.path.join(CSRC_DIR, "fused_sdf.cu")

MAX_LAYERS = 16      # csrc/fused_sdf.cu MAX_LAYERS
WIDTH = 256          # csrc/fused_sdf.cu WIDTH: N of every hidden product
KCHUNK = 64          # csrc/fused_sdf.cu KCHUNK: K per stage
MAX_MULTIRES = 10    # d_pe <= 63: layer 0's input is one K chunk
INV_SQRT2 = 0.7071067811865475
MODES = ("float32", "bfloat16")
# |w - (hi + lo)| <= 2^-16 |w|: each half rounded to nearest bf16 (8
# significant bits) is within 2^-8 of what it rounds.
SPLIT_REL_ERR = 2.0 ** -16
# The bf16 activation's table (csrc/fused_sdf.cu, act2_bf16): the band
# ACT_LO <= |h|'s bf16 bits < ACT_HI (2^-16 <= |h| < 1), entry 1 + 2 (m -
# ACT_LO) + sign for bits m; entry 0 the value below the band; then the
# sentinel that hands h beyond the band to the closed form; zero-padded
# to whole 16 bytes.
ACT_LO, ACT_HI = 0x3780, 0x3F80
ACT_SPAN = ACT_HI - ACT_LO
ACT_SENTINEL = 0x8000
ACT_TABLE_LEN = -(-(2 * ACT_SPAN + 2) // 8) * 8


class SdfMeta(ctypes.Structure):
    """Mirror of `struct SdfMeta` in csrc/fused_sdf.cu (passed by value)."""
    _fields_ = [
        ("n_hidden", ctypes.c_int),
        ("n_stages", ctypes.c_int),
        ("skip", ctypes.c_int),
        ("pe_col", ctypes.c_int),
        ("d_pe", ctypes.c_int),
        ("mode", ctypes.c_int),
        ("act_bf16", ctypes.c_int),
        ("bounding_sphere", ctypes.c_float),
        ("sphere_scale", ctypes.c_float),
        ("skip_scale", ctypes.c_float),
        ("chunks", ctypes.c_int * MAX_LAYERS),
    ]


def supported(cfg: ModelConfig) -> bool:
    """The family the kernel covers: 3-D input with PE (multires <= 10),
    uniform hidden width <= 256, at most one skip junction, at most 16
    layers. Same family as the Pallas kernel's `supported`."""
    imp = cfg.implicit
    return (imp.d_in == 3 and 0 < imp.multires <= MAX_MULTIRES
            and len(set(imp.dims)) == 1 and imp.dims[0] <= WIDTH
            and len(imp.skip_in) <= 1
            and all(0 < s <= len(imp.dims) for s in imp.skip_in)
            and len(imp.dims) + 1 <= MAX_LAYERS)


def mode(cfg: ModelConfig) -> str:
    """The kernel mode of a model config: "bfloat16" for bf16 products,
    else "float32"."""
    return "bfloat16" if cfg.compute_dtype == "bfloat16" else "float32"


def act_bf16(cfg: ModelConfig) -> bool:
    """bf16 activations (only alongside bf16 products, as in
    models/network.activation_dtype)."""
    return cfg.activation_dtype == "bfloat16" and mode(cfg) == "bfloat16"


def bf16r(x: torch.Tensor) -> torch.Tensor:
    """x rounded to nearest bf16, as float32."""
    return x.to(torch.bfloat16).float()


def normalized_weights(sdf_params) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Materialise every layer to a plain detached (W (in, out), b) pair
    (W (S, in, out) and b (S, out) for stacked parameters)."""
    return [(p.weight().detach(), p.b.detach()) for p in sdf_params]


def scene_weights(wb, s: int):
    """Scene s's (W, b) pairs of stacked `normalized_weights`."""
    return [(w[s], b[s]) for w, b in wb]


def sdf_values_plain(sdf_params, cfg: ModelConfig, pts: torch.Tensor,
                     bounding_sphere: float) -> torch.Tensor:
    """What the kernel computes in `cfg`'s mode, as one torch.matmul per
    layer: the clamped SDF (N,) of pts (N, 3), or with stacked
    parameters (S, N) of pts (S, N, 3), one scene after another. The
    last layer is applied to its SDF column only. Softplus is
    `layers.softplus_b`'s jax.nn form.

    The bfloat16 mode rounds where the kernel rounds: every layer's
    input and weights to bf16 (the float32 product of bf16 values is
    their exact products summed in float32); with bf16 activations also
    the pre-activation, and the softplus op by op in bf16 (100 h, the
    exp, the log1p, the sum and the quotient each rounded), as the JAX
    package's bf16 program rounds it and the port's training MLP does
    (`models.network.sdf_mlp_raw`); the skip junction's
    [h, pe] * 1/sqrt(2) (bf16(1/sqrt(2)) with bf16 activations) before
    its rounding."""
    with torch.no_grad():
        wb = normalized_weights(sdf_params)
        S = n_scenes(sdf_params)
        if not S:
            return _plain(wb, cfg, pts, bounding_sphere)
        if pts.dim() != 3 or pts.shape[0] != S:
            raise ValueError(f"sdf_values_plain: {S} scenes' parameters "
                             f"want points (S, N, 3), got {tuple(pts.shape)}")
        return torch.stack([_plain(scene_weights(wb, s), cfg, pts[s],
                                   bounding_sphere) for s in range(S)])


def _plain(wb, cfg: ModelConfig, pts: torch.Tensor,
           bounding_sphere: float) -> torch.Tensor:
    """`sdf_values_plain` of one scene's (W, b) pairs."""
    imp = cfg.implicit
    bf16 = mode(cfg) == "bfloat16"
    act = act_bf16(cfg)
    with torch.no_grad():
        inp = positional_encoding(pts, imp.multires)
        h = inp
        for l, (w, b) in enumerate(wb):
            if l in imp.skip_in:
                if bf16 and act:
                    h = torch.cat([h, bf16r(inp)], dim=-1) * bf16r(
                        torch.tensor(INV_SQRT2))
                else:
                    h = torch.cat([h, inp], dim=-1) * INV_SQRT2
            if l == len(wb) - 1:
                w = w[:, :1]
            if bf16:
                h, w = bf16r(h), bf16r(w)
            if l == len(wb) - 1:
                h = h @ w + b[:1]
            else:
                z = h @ w + b
                if act:
                    h = softplus_b(z.to(torch.bfloat16), beta=100.0).float()
                else:
                    h = softplus_b(z, beta=100.0)
        sdf = h[:, 0]
        if bounding_sphere > 0.0:
            r = torch.linalg.norm(pts, dim=-1)
            sdf = torch.minimum(sdf, imp.sphere_scale * (bounding_sphere - r))
        return sdf


def act_bf16_inputs() -> torch.Tensor:
    """The bf16 values h whose activations the kernel's table holds, in
    its order, as float32: 0 (the value below the band), then for each
    |h|'s bits m in [ACT_LO, ACT_HI), +h and -h."""
    m = np.arange(ACT_LO, ACT_HI, dtype=np.uint32)
    bits = np.concatenate([[0], np.stack([m, m | 0x8000], -1).ravel()])
    return torch.from_numpy((bits.astype(np.uint32) << 16).view(np.float32))


_ACT_TABLES = {}


def act_bf16_table(device) -> torch.Tensor:
    """The kernel's table of the bf16 activation (int16 bf16 bits,
    ACT_TABLE_LEN), on `device`: `act_bf16_values`' plain form (torch's
    bf16 ops) of `act_bf16_inputs`, computed on that device once a
    process, then the sentinel."""
    device = torch.device(device)
    with _LIB_LOCK:
        if device not in _ACT_TABLES:
            h = act_bf16_inputs().to(device)
            vals = softplus_b(h.to(torch.bfloat16), beta=100.0)
            table = torch.zeros(ACT_TABLE_LEN, dtype=torch.int16,
                                device=device)
            table[:h.numel()] = vals.view(torch.int16)
            table[h.numel()] = ACT_SENTINEL - (1 << 16)
            _ACT_TABLES[device] = table
        return _ACT_TABLES[device]


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (f32) as hi + lo, each rounded to nearest bf16: the kernel's
    split of every operand."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def swizzle128(t: torch.Tensor) -> torch.Tensor:
    """(..., rows, 64) bf16: each row is 128 bytes, eight 16-byte units;
    unit u of row r moves to u ^ (r % 8), the tensor cores' 128-byte
    swizzle (it is its own inverse)."""
    rows = t.shape[-2]
    r = torch.arange(rows, device=t.device)
    u = torch.arange(8, device=t.device)
    idx = (u[None, :] ^ (r[:, None] % 8))[..., None].expand(rows, 8, 8)
    t8 = t.reshape(*t.shape[:-1], 8, 8)
    return torch.gather(t8, -2, idx.expand_as(t8)).reshape(t.shape)


@dataclasses.dataclass
class SdfPack:
    """The kernel's operands for one version of the SDF weights.

    mode: "float32" or "bfloat16" (`mode`), also in meta.mode.
    weights: (n_stages, 256, 64) bf16, the stream the kernel's producer
      copies stage by stage: for each hidden layer, for each K chunk of
      64, W_hi then (float32 mode only) W_lo of that chunk, as
      (out, in) (K-major), zero-padded to N = 256 and K = 64 * chunks,
      in the 128-byte swizzle. In the float32 mode the skip layer's
      1/sqrt(2) is folded in; the bfloat16 mode applies it in the
      kernel's epilogue, where JAX's bf16 multiply rounds.
    vec: f32, the hidden layers' biases (n_hidden x 256, zero-padded),
      then the SDF column of the last layer (256, zero-padded), its
      rows that multiply the encoding when the skip junction feeds the
      last layer (64, else zeros), and its bias. The bfloat16 mode's
      SDF column and encoding rows are bf16-rounded.
    meta: the layer table (bounding_sphere and sphere_scale are set per
      launch).
    scenes: 0 for one set of weights; S for `pack_sdf_scenes`' pack of S
      scenes, whose weights are (S, n_stages, 256, 64) and vec (S, L)
      whose row s is scene s's `pack_sdf` vector, zero-padded to a
      multiple of 4 floats (the kernel reads the vector in pairs)."""
    mode: str
    weights: torch.Tensor
    vec: torch.Tensor
    meta: SdfMeta
    scenes: int = 0


def pack_sdf(sdf_params, cfg: ModelConfig, device=None) -> SdfPack:
    """Weight norm and the padded, swizzled K-major layout of `cfg`'s
    mode, on `device` (default: the weights'): the 1/sqrt(2) fold and the
    hi/lo split (float32), or W rounded to nearest bf16 (bfloat16)."""
    if n_scenes(sdf_params):
        raise ValueError("pack_sdf: stacked parameters; use pack_sdf_scenes")
    pack_sdf.builds += 1
    with torch.no_grad():
        wb = normalized_weights(sdf_params)
        device = torch.device(device) if device is not None \
            else wb[0][0].device
        return _pack(wb, cfg, device)


def pack_sdf_scenes(sdf_params, cfg: ModelConfig, device=None) -> SdfPack:
    """`pack_sdf` of each scene of stacked parameters (leaves with a
    leading S axis), stacked into one pack: weights (S, n_stages, 256,
    64) and vec (S, L) (see SdfPack). One build."""
    S = n_scenes(sdf_params)
    if not S:
        raise ValueError("pack_sdf_scenes: parameters without a scene axis")
    pack_sdf.builds += 1
    with torch.no_grad():
        wb = normalized_weights(sdf_params)
        device = torch.device(device) if device is not None \
            else wb[0][0].device
        packs = [_pack(scene_weights(wb, s), cfg, device) for s in range(S)]
        n = packs[0].vec.numel()
        vec = torch.stack([torch.nn.functional.pad(p.vec, (0, -n % 4))
                           for p in packs])
        return SdfPack(packs[0].mode, torch.stack([p.weights for p in packs]),
                       vec, packs[0].meta, S)


def _pack(wb, cfg: ModelConfig, device) -> SdfPack:
    """The pack of one scene's (W, b) pairs on `device`."""
    imp = cfg.implicit
    bf16 = mode(cfg) == "bfloat16"
    with torch.no_grad():
        n_hidden = len(wb) - 1
        skip = imp.skip_in[0] if imp.skip_in else -1
        meta = SdfMeta()
        meta.n_hidden = n_hidden
        meta.skip = skip
        meta.pe_col = wb[skip - 1][0].shape[1] if skip > 0 else 0
        meta.d_pe = embed_dim(imp.multires, imp.d_in)
        meta.mode = MODES.index(mode(cfg))
        meta.act_bf16 = int(act_bf16(cfg))
        meta.skip_scale = (float(bf16r(torch.tensor(INV_SQRT2)))
                           if act_bf16(cfg) else INV_SQRT2) if bf16 else 1.0
        wt = torch.zeros((n_hidden, WIDTH, WIDTH), device=device)
        vec = torch.zeros((n_hidden + 1) * WIDTH + KCHUNK + 1, device=device)
        take = []
        for l, (w, b) in enumerate(wb):
            w = w.to(device=device, dtype=torch.float32)
            b = b.to(device=device, dtype=torch.float32)
            if l == skip and not bf16:
                w = w * INV_SQRT2
            if l == n_hidden:
                col = bf16r(w[:, 0]) if bf16 else w[:, 0]
                if l == skip:   # [h, pe]: the pe part goes after the column
                    vec[(l + 1) * WIDTH:(l + 1) * WIDTH + meta.d_pe] = \
                        col[meta.pe_col:]
                    col = col[:meta.pe_col]
                vec[l * WIDTH:l * WIDTH + col.shape[0]] = col
                vec[-1] = b[0]
                break
            k, n = w.shape
            wt[l, :n, :k] = w.T
            vec[l * WIDTH:l * WIDTH + n] = b
            meta.chunks[l] = -(-k // KCHUNK)
            take += [l * (WIDTH // KCHUNK) + c for c in range(meta.chunks[l])]
        # (layer, chunk, hi[/lo], N, K chunk), then the chunks each layer
        # has.
        parts = [wt.to(torch.bfloat16)] if bf16 else list(split_bf16(wt))
        stages = torch.stack(parts, dim=1).reshape(
            n_hidden, len(parts), WIDTH, WIDTH // KCHUNK, KCHUNK).permute(
                0, 3, 1, 2, 4)
        stages = stages.reshape(-1, len(parts), WIDTH, KCHUNK)[
            torch.tensor(take, device=device)].reshape(-1, WIDTH, KCHUNK)
        meta.n_stages = stages.shape[0]
        return SdfPack(mode(cfg), swizzle128(stages).contiguous(), vec, meta)


pack_sdf.builds = 0


_LIB = None
_LIB_LOCK = threading.Lock()


def build(force: bool = False) -> str:
    """Compile csrc/fused_sdf.cu into _build/libfused_sdf.so unless an
    up-to-date library exists (`ops.build.build_library`). Raises on
    failure."""
    return build_library([nvcc()] + NVCC_FLAGS, SOURCE, "libfused_sdf.so",
                         force)


def bind(path: str):
    """Load a build of csrc/fused_sdf.cu and declare its C entry points."""
    lib = ctypes.CDLL(path)
    lib.fused_sdf_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, SdfMeta, ctypes.c_void_p]
    lib.fused_sdf_forward.restype = ctypes.c_int
    lib.fused_sdf_forward_scenes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, SdfMeta,
        ctypes.c_void_p]
    lib.fused_sdf_forward_scenes.restype = ctypes.c_int
    lib.fused_sdf_act_bf16.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                       ctypes.c_int, ctypes.c_void_p,
                                       ctypes.c_void_p]
    lib.fused_sdf_act_bf16.restype = ctypes.c_int
    lib.fused_sdf_error_string.argtypes = [ctypes.c_int]
    lib.fused_sdf_error_string.restype = ctypes.c_char_p
    return lib


def _load():
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            _LIB = bind(build())
        return _LIB


def fused_sdf_values(sdf_params, cfg: ModelConfig, pts: torch.Tensor,
                     bounding_sphere: float,
                     pack: Optional[SdfPack] = None) -> torch.Tensor:
    """Clamped SDF values (N,) of pts (N, 3) f32, without gradient; with
    stacked parameters (S scenes), (S, N) of pts (S, N, 3).

    A pack of another mode than `cfg`'s, or of another number of scenes
    than the parameters', raises. CPU tensor: `sdf_values_plain` (`pack`
    otherwise unused). CUDA tensor: one launch of the fused kernel in
    `cfg`'s mode on the current stream, for all S scenes at once
    (counted in `fused_sdf_values.launches`, by mode in
    `fused_sdf_values.mode_launches` and by number of scenes in
    `fused_sdf_values.scene_launches`) with `pack` (`pack_sdf`, or
    `pack_sdf_scenes` for stacked parameters, of the same weights and
    mode; packed here when None), or an exception."""
    if pack is not None and (pack.mode, bool(pack.meta.act_bf16)) != (
            mode(cfg), act_bf16(cfg)):
        raise ValueError(f"fused_sdf_values: a {pack.mode} pack (bf16 "
                         f"activations {bool(pack.meta.act_bf16)}) for a "
                         f"config of mode {mode(cfg)} (bf16 activations "
                         f"{act_bf16(cfg)})")
    S = n_scenes(sdf_params)
    if pack is not None and pack.scenes != S:
        raise ValueError(f"fused_sdf_values: a pack of {pack.scenes} scenes "
                         f"for parameters of {S} (0: no scene axis)")
    if pts.dim() != (3 if S else 2) or (S and pts.shape[0] != S):
        raise ValueError(f"fused_sdf_values: want points "
                         f"{'(S, N, 3) for S = %d' % S if S else '(N, 3)'}, "
                         f"got {tuple(pts.shape)}")
    if pts.device.type == "cpu":
        return sdf_values_plain(sdf_params, cfg, pts, bounding_sphere)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_sdf_values: unsupported device {pts.device}")
    if not supported(cfg):
        raise ValueError(f"fused_sdf_values: config outside the kernel's "
                         f"family: {cfg.implicit}")
    if pts.dtype != torch.float32 or pts.shape[-1] != 3:
        raise ValueError(f"fused_sdf_values: want float32 points (..., 3), "
                         f"got {tuple(pts.shape)} {pts.dtype}")
    if not pts.is_contiguous():
        raise ValueError("fused_sdf_values: points must be contiguous")
    n = pts.shape[-2]
    if n * max(S, 1) >= 2 ** 31:
        raise ValueError(f"fused_sdf_values: {n} x {max(S, 1)} points exceed "
                         f"int32 indexing")
    if pack is None:
        pack = (pack_sdf_scenes if S else pack_sdf)(sdf_params, cfg,
                                                    pts.device)
    if pack.weights.device != pts.device:
        raise ValueError(f"fused_sdf_values: pack on {pack.weights.device}, "
                         f"points on {pts.device}")
    lib = _load()
    meta = SdfMeta.from_buffer_copy(pack.meta)
    meta.bounding_sphere = float(bounding_sphere)
    meta.sphere_scale = float(cfg.implicit.sphere_scale)
    out = torch.empty(pts.shape[:-1], dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    table = act_bf16_table(pts.device).data_ptr() if meta.act_bf16 else None
    stream = torch.cuda.current_stream(pts.device).cuda_stream
    rc = lib.fused_sdf_forward_scenes(
        pts.data_ptr(), pack.weights.data_ptr(), pack.vec.data_ptr(), table,
        out.data_ptr(), n, max(S, 1), pack.vec.shape[-1] if S else 0, meta,
        stream)
    if rc != 0:
        raise RuntimeError("fused_sdf kernel launch failed: "
                           + lib.fused_sdf_error_string(rc).decode())
    fused_sdf_values.launches += 1
    fused_sdf_values.mode_launches[pack.mode] += 1
    scenes = fused_sdf_values.scene_launches
    scenes[max(S, 1)] = scenes.get(max(S, 1), 0) + 1
    return out


def act_bf16_values(z: torch.Tensor) -> torch.Tensor:
    """The bfloat16 mode's activation of a hidden unit, elementwise on
    float32 z: the pre-activation rounded to bf16, softplus(100 h) / 100
    op by op in bf16 (`models.layers.softplus_b` on a bf16 tensor). CPU
    tensor: that plain form. CUDA tensor: the kernel's own activation
    (`act2_bf16` with `act_bf16_table`, through the C entry
    fused_sdf_act_bf16), for a check of it over every bf16 input; not a
    launch of the SDF kernel, and not counted."""
    if z.device.type == "cpu":
        return softplus_b(z.to(torch.bfloat16), beta=100.0).float()
    if z.dtype != torch.float32 or not z.is_contiguous():
        raise ValueError(f"act_bf16_values: want contiguous float32, got "
                         f"{z.dtype}")
    out = torch.empty_like(z)
    lib = _load()
    rc = lib.fused_sdf_act_bf16(z.data_ptr(), out.data_ptr(), z.numel(),
                                act_bf16_table(z.device).data_ptr(),
                                torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("fused_sdf_act_bf16 launch failed: "
                           + lib.fused_sdf_error_string(rc).decode())
    return out


# Sweeps of the sampler that took the plain route
# (`models.network.sampler_sdf_fn`: the CPU, or a config outside
# `supported`), beside the kernel's launch counts.
plain_sweeps = 0


def reset_launches() -> None:
    """Set the launch counts, the total, each mode's and each number of
    scenes', and the plain sweeps to 0."""
    global plain_sweeps
    fused_sdf_values.launches = 0
    fused_sdf_values.mode_launches = dict.fromkeys(MODES, 0)
    fused_sdf_values.scene_launches = {}
    plain_sweeps = 0


reset_launches()
