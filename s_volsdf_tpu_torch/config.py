"""The slice of the configuration tree that the PyTorch port reads.

Same dataclasses, field names and defaults as `s_volsdf_tpu.config`
(tests/test_torch_config.py holds every default equal). The port keeps
its own copy because importing `s_volsdf_tpu` runs that package's
`__init__`, which imports JAX wherever JAX is installed, and the port
must run without it.

The seven precision knobs (`train.train_compute_dtype`,
`train.train_activation_dtype`, `train.mvs_pack_dtype`,
`train.feedback_render_dtype`, `model.compute_dtype`,
`model.activation_dtype`, `mvs.compute_dtype`) take "float32" or
"bfloat16" with the JAX package's defaults and meanings; `check_ported`
validates them and refuses what the port does not implement (the orbax
checkpoint backend).
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass(unsafe_hash=True)
class ImplicitNetConfig:
    d_in: int = 3
    d_out: int = 1
    dims: Tuple[int, ...] = (256,) * 8
    geometric_init: bool = True
    bias: float = 0.6
    skip_in: Tuple[int, ...] = (4,)
    weight_norm: bool = True
    multires: int = 6
    sphere_scale: float = 20.0


@dataclass(unsafe_hash=True)
class RenderingNetConfig:
    mode: str = "idr"  # 'idr' | 'nerf'
    d_in: int = 9
    d_out: int = 3
    dims: Tuple[int, ...] = (256,) * 4
    weight_norm: bool = True
    multires_view: int = 1


@dataclass(unsafe_hash=True)
class DensityConfig:
    beta_init: float = 0.1
    beta_min: float = 1e-4


@dataclass(unsafe_hash=True)
class RaySamplerConfig:
    near: float = 1e-4
    N_samples: int = 64
    N_samples_eval: int = 128
    N_samples_extra: int = 32
    eps: float = 0.1
    beta_iters: int = 10
    max_total_iters: int = 5
    inverse_sphere_bg: bool = False
    N_samples_inverse_sphere: int = 0
    add_tiny: float = 0.0


@dataclass(unsafe_hash=True)
class BGNetworkConfig:
    """The NeRF++ background networks of a BlendedMVS scene: an SDF MLP
    over inverted-sphere points (x', y', z', 1/r) and a 'nerf'-mode
    colour MLP."""
    feature_vector_size: int = 256
    implicit: ImplicitNetConfig = field(default_factory=lambda: ImplicitNetConfig(
        d_in=4, d_out=1, dims=(256,) * 8, geometric_init=False, bias=0.0,
        skip_in=(4,), weight_norm=False, multires=10))
    rendering: RenderingNetConfig = field(default_factory=lambda: RenderingNetConfig(
        mode="nerf", d_in=3, d_out=3, dims=(128,), weight_norm=False,
        multires_view=4))


@dataclass(unsafe_hash=True)
class ModelConfig:
    feature_vector_size: int = 256
    scene_bounding_sphere: float = 3.0
    white_bkgd: bool = False
    compute_dtype: str = "float32"
    activation_dtype: str = "float32"
    bg_color: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    with_background: bool = False
    implicit: ImplicitNetConfig = field(default_factory=ImplicitNetConfig)
    rendering: RenderingNetConfig = field(default_factory=RenderingNetConfig)
    density: DensityConfig = field(default_factory=DensityConfig)
    sampler: RaySamplerConfig = field(default_factory=RaySamplerConfig)
    bg: BGNetworkConfig = field(default_factory=BGNetworkConfig)


@dataclass(unsafe_hash=True)
class PlotConfig:
    """Mesh export's grid (`grid_boundary`, `level`; engine/eval_nvs.py)
    and the training plot's knobs, which the JAX package carries for
    parity and does not read either (`plot_nimgs`, `resolution`)."""
    plot_nimgs: int = 1
    resolution: int = 100
    grid_boundary: Tuple[float, float] = (-1.5, 1.5)
    level: float = 0.0


@dataclass(unsafe_hash=True)
class LossConfig:
    eikonal_weight: float = 0.1
    rgb_weight: float = 1.0
    mvs_weight: float = 1.0
    sparse_weight: float = 1.0
    confi: float = 1e-3
    gce: float = 0.5
    anneal_rgb: int = 200
    # Gate rescue (off by default): an L1 pull of the rendered depth to
    # the prior's winner-take-all depth on rays whose GCE gate is closed
    # and whose prior peaks above gate_rescue_peak.
    gate_rescue: bool = False
    gate_rescue_weight: float = 0.1
    gate_rescue_peak: float = 0.02


@dataclass(unsafe_hash=True)
class TrainConfig:
    expname: str = "ours"
    learning_rate: float = 5e-4
    num_pixels: int = 512
    checkpoint_freq: int = 100     # epochs between epoch_<n> snapshots
    plot_freq: int = 500
    render_freq: int = 500         # epochs between plot renders; <= 0 off
    split_n_pixels: int = 10000
    grad_clip: bool = True
    mvs_pack_dtype: str = "bfloat16"
    train_compute_dtype: str = "bfloat16"
    train_activation_dtype: str = "bfloat16"
    feedback_render_dtype: str = "float32"
    ckpt_backend: str = "npz"      # "orbax" is refused (check_ported)


@dataclass(unsafe_hash=True)
class DatasetConfig:
    data_dir: str = "DTU"          # 'DTU' | 'BlendedMVS'
    img_res: Tuple[int, int] = (576, 768)
    scan_id: int = 114
    num_views: int = 3
    data_dir_root: str = "data_s_volsdf"


@dataclass(unsafe_hash=True)
class MVSConfig:
    model_name: str = "casmvsnet"  # one of MVS_MODELS
    ndepths: Tuple[int, ...] = (192, 32, 8)
    depth_inter_r: Tuple[float, ...] = (1.0, 0.5, 0.5)
    numdepth: int = 192
    interval_scale: float = 1.06
    share_cr: bool = False
    cr_base_chs: Tuple[int, ...] = (8, 8, 8)
    grad_method: str = "detach"
    x2_mvsres: bool = True         # upscale images x2 for MVS
    fea_base_channels: int = 8
    compute_dtype: str = "bfloat16"


@dataclass(unsafe_hash=True)
class FilterConfig:
    """Point-cloud fusion (engine/fusion.py, runner.pcd_filter)."""
    conf: float = 0.0
    filter_dist: float = 1.0
    filter_diff: float = 0.01
    thres_view: int = 1
    eval_mask: bool = True


@dataclass(unsafe_hash=True)
class ParallelConfig:
    """Multi-device runs (counterpart of s_volsdf_tpu/config.py:237-249;
    `parallel/`): the node's ranks arranged as `mesh_shape` over
    `mesh_axes` (-1 takes every rank left), one scene's rays sharded
    over them in training (`shard_rays`), the eval and feedback renders'
    rays and the SDF grids' points sharded over them (`shard_eval`), and
    the cascade one reference view a rank (`shard_mvs_views`; None
    follows shard_eval)."""
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("rays",)
    shard_rays: bool = True
    shard_eval: bool = True
    shard_mvs_views: Optional[bool] = None


@dataclass(unsafe_hash=True)
class Config:
    num_view: int = 3
    testlist: str = "scan106"
    outdir: str = "exps_mvs"
    exps_folder: str = "exps_vsdf"
    data_dir_root: str = "data_s_volsdf"
    max_h: int = 576
    max_w: int = 768
    use_mvs: bool = True
    opt_stepNs: Tuple[int, ...] = (100000, 0, 0)
    use_nerf_d: Tuple[int, ...] = (1, 0, 0)
    inverse_depth: bool = False
    ablate: bool = False
    filter_only: bool = False
    num_worker: int = 4
    is_continue: bool = False
    seed: int = 0
    mvs: MVSConfig = field(default_factory=MVSConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    plot: PlotConfig = field(default_factory=PlotConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)


def dtu_config() -> Config:
    """Counterpart of `s_volsdf_tpu.config.dtu_config` (the DTU preset
    that `load_config("dtu")` returns)."""
    cfg = Config()
    cfg.train.expname = "ours"
    cfg.train.num_pixels = 512
    cfg.train.render_freq = 500
    cfg.train.split_n_pixels = 500
    return cfg


def bmvs_config() -> Config:
    """Counterpart of `s_volsdf_tpu.config.bmvs_config`: the NeRF++
    background model, inverse-sphere background samples, an unclamped
    foreground SDF."""
    cfg = dtu_config()
    cfg.dataset.data_dir = "BlendedMVS"
    cfg.dataset.scan_id = 1
    cfg.model.with_background = True
    cfg.model.implicit.sphere_scale = 1.0
    cfg.model.sampler.inverse_sphere_bg = True
    cfg.model.sampler.N_samples_inverse_sphere = 32
    cfg.model.sampler.add_tiny = 1e-6
    return cfg


def per_scene_overrides(cfg: Config, scene: str) -> Config:
    """Per-scan tweaks (counterpart of s_volsdf_tpu/config.py:309-323)."""
    cfg = dataclasses.replace(cfg)  # shallow copy of top level
    cfg.loss = dataclasses.replace(cfg.loss)
    if cfg.dataset.data_dir == "DTU":
        if scene == "scan37":
            cfg.loss.sparse_weight = 0.1
        elif scene == "scan24":
            cfg.loss.sparse_weight = 0.0
    elif cfg.dataset.data_dir == "BlendedMVS":
        if scene in ("scan2", "scan3", "scan7", "scan9"):
            cfg.loss.sparse_weight = 0.0
        if scene in ("scan1", "scan2", "scan5", "scan6", "scan8", "scan9"):
            cfg.inverse_depth = True
    return cfg


# --------------------------------------------------------------------------
# Presets and dotted command-line overrides (s_volsdf_tpu/config.py:330-395)
# --------------------------------------------------------------------------

_PRESETS = {"dtu": dtu_config, "bmvs": bmvs_config, "default": Config}


def _parse_literal(value: str) -> Any:
    """A command-line value by JSON rules (`[20,0,0]`, `1e-3`, `null`),
    then Python literal rules (`(1, 2)`, `None`), then as a flow list of
    bare words as YAML reads it (`[scene,rays]`), else the string."""
    try:
        return json.loads(value)
    except ValueError:
        pass
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        pass
    if value.startswith("[") and value.endswith("]"):
        return [_parse_literal(v.strip()) for v in value[1:-1].split(",")
                if v.strip()]
    return value


def _coerce(value: str, current: Any) -> Any:
    """Parse a command-line string into the type of the field's value."""
    if current is None:
        return _parse_literal(value)
    if isinstance(current, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int):
        return int(value)
    if isinstance(current, float):
        return float(value)
    if isinstance(current, tuple):
        parsed = _parse_literal(value)
        if not isinstance(parsed, (list, tuple)):
            parsed = [parsed]
        return tuple(parsed)
    return value


def apply_override(cfg: Any, dotted_key: str, value: str) -> None:
    """Set `cfg.<dotted.key> = value` with type coercion. A key or
    section the port's config does not have raises, naming the key.
    A field whose default is None (parallel.shard_mvs_views) parses by
    literal rules whatever it holds, so "null" resets it."""
    parts = dotted_key.split(".")
    obj = cfg
    for i, p in enumerate(parts):
        names = ({f.name for f in dataclasses.fields(obj)}
                 if dataclasses.is_dataclass(obj) else set())
        if p not in names:
            raise ValueError(f"config override {dotted_key!r}: the port's "
                           f"config has no {'.'.join(parts[:i + 1])!r}")
        if i < len(parts) - 1:
            obj = getattr(obj, p)
    fld = next(f for f in dataclasses.fields(obj) if f.name == parts[-1])
    current = None if fld.default is None else getattr(obj, parts[-1])
    setattr(obj, parts[-1], _coerce(value, current))


def load_config(preset: str = "dtu",
                overrides: Optional[List[str]] = None) -> Config:
    """A Config from a preset ("dtu", "bmvs" or "default") and
    `key.subkey=value` overrides. The JAX loader's YAML file argument
    is left out: the card's machine has no YAML parser."""
    cfg = _PRESETS[preset]()
    for ov in overrides or []:
        key, _, value = ov.partition("=")
        apply_override(cfg, key.strip(), value.strip())
    return cfg


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def validate_config(cfg: Config) -> Config:
    """The invariants of s_volsdf_tpu/config.py:400-415 that the cascade
    and the trainer rely on; raises ValueError."""
    _require(cfg.dataset.data_dir in ("DTU", "BlendedMVS"),
             f"dataset.data_dir={cfg.dataset.data_dir!r}")
    _require(len(cfg.mvs.ndepths) == len(cfg.mvs.depth_inter_r) == 3,
             "mvs.ndepths and mvs.depth_inter_r need 3 stages")
    _require(len(cfg.opt_stepNs) == 3 and len(cfg.use_nerf_d) == 3,
             "opt_stepNs and use_nerf_d need 3 stages")
    _require(cfg.mvs.numdepth == cfg.mvs.ndepths[0],
             "numdepth must match stage-1 hypothesis count")
    if cfg.dataset.data_dir == "BlendedMVS":
        _require(cfg.mvs.interval_scale == 1.0,
                 "BlendedMVS requires interval_scale=1")
    for d in cfg.mvs.ndepths:
        _require(d % 8 == 0, f"ndepths must be multiples of 8 (3-level "
                 f"cost UNet), got {d}")
    H, W = cfg.dataset.img_res
    _require((cfg.max_h, cfg.max_w) == (H, W),
             "max_h/max_w must equal dataset.img_res")
    _require(H % 32 == 0 and W % 32 == 0,
             "img_res must be multiples of 32 for the MVS pyramids")
    return cfg


def save_config(cfg: Config, path: str) -> None:
    """Snapshot the config as JSON, which YAML readers also parse (the
    JAX package writes the same file name with PyYAML)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=1)


PRECISION_KNOBS = (
    ("train", "train_compute_dtype"), ("train", "train_activation_dtype"),
    ("train", "mvs_pack_dtype"), ("train", "feedback_render_dtype"),
    ("model", "compute_dtype"), ("model", "activation_dtype"),
    ("mvs", "compute_dtype"))
DTYPES = ("float32", "bfloat16")


def check_model_ported(mcfg: ModelConfig) -> ModelConfig:
    """Validate the model's two precision knobs."""
    for name in ("compute_dtype", "activation_dtype"):
        _require(getattr(mcfg, name) in DTYPES,
                 f"model.{name}={getattr(mcfg, name)!r}: want one of {DTYPES}")
    return mcfg


MVS_MODELS = ("casmvsnet", "ucsnet", "transmvsnet")


def check_mvs_ported(mcfg: MVSConfig) -> MVSConfig:
    """Validate the cascade's model name and precision knob."""
    _require(mcfg.model_name in MVS_MODELS,
             f"mvs.model_name={mcfg.model_name!r}: want one of {MVS_MODELS}")
    _require(mcfg.compute_dtype in DTYPES,
             f"mvs.compute_dtype={mcfg.compute_dtype!r}: want one of {DTYPES}")
    return mcfg


def check_ported(cfg: Config) -> Config:
    """Validate the seven precision knobs and the checkpoint backend (as
    s_volsdf_tpu/config.py:416-429 does; ValueError) and raise
    NotImplementedError on the orbax checkpoint backend, which the port
    does not implement."""
    for section, name in PRECISION_KNOBS:
        value = getattr(getattr(cfg, section), name)
        _require(value in DTYPES,
                 f"{section}.{name}={value!r}: want one of {DTYPES}")
    _require(cfg.train.ckpt_backend in ("npz", "orbax"),
             f"train.ckpt_backend={cfg.train.ckpt_backend!r}")
    check_model_ported(cfg.model)
    if cfg.train.ckpt_backend == "orbax":
        raise NotImplementedError("train.ckpt_backend='orbax' is not ported "
                                  "(the card's machine has no orbax): use "
                                  "'npz'")
    return cfg
