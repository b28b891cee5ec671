"""The slice of the configuration tree that the PyTorch port reads.

Same dataclasses, field names and defaults as `s_volsdf_tpu.config`
(tests/test_torch_config.py holds every default equal). The port keeps
its own copy because importing `s_volsdf_tpu` runs that package's
`__init__`, which imports JAX wherever JAX is installed, and the port
must run without it.

The port runs float32 only: `check_float32` raises on the bf16 knobs
instead of ignoring them (their JAX defaults are bf16, so callers set
the three `train.*_dtype` knobs to "float32").
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Tuple


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
    add_tiny: float = 0.0


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


@dataclass(unsafe_hash=True)
class LossConfig:
    eikonal_weight: float = 0.1
    rgb_weight: float = 1.0
    mvs_weight: float = 1.0
    sparse_weight: float = 1.0
    confi: float = 1e-3
    gce: float = 0.5
    anneal_rgb: int = 200
    gate_rescue: bool = False


@dataclass(unsafe_hash=True)
class TrainConfig:
    learning_rate: float = 5e-4
    num_pixels: int = 512
    grad_clip: bool = True
    mvs_pack_dtype: str = "bfloat16"
    train_compute_dtype: str = "bfloat16"
    train_activation_dtype: str = "bfloat16"
    feedback_render_dtype: str = "float32"


@dataclass(unsafe_hash=True)
class Config:
    max_h: int = 576
    max_w: int = 768
    use_mvs: bool = True
    seed: int = 0
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)


def dtu_config() -> Config:
    """Counterpart of `s_volsdf_tpu.config.dtu_config` (the DTU preset
    that `load_config("dtu")` returns)."""
    cfg = Config()
    cfg.train.num_pixels = 512
    return cfg


def _require_float32(section, prefix: str, names) -> None:
    for name in names:
        value = getattr(section, name)
        if value != "float32":
            raise NotImplementedError(
                f"{prefix}.{name}={value!r}: the PyTorch port runs float32 "
                f"only; set it to 'float32'")


def check_model_float32(mcfg: ModelConfig) -> ModelConfig:
    """Raise on a bf16 model knob or the BMVS background model."""
    _require_float32(mcfg, "model", ("compute_dtype", "activation_dtype"))
    if mcfg.with_background:
        raise NotImplementedError("model.with_background (BMVS) is not ported")
    return mcfg


def check_float32(cfg: Config) -> Config:
    """Raise on what the port does not implement: any precision knob
    other than "float32", the BMVS background model and gate rescue."""
    _require_float32(cfg.train, "train", (
        "train_compute_dtype", "train_activation_dtype", "mvs_pack_dtype",
        "feedback_render_dtype"))
    check_model_float32(cfg.model)
    if cfg.loss.gate_rescue:
        raise NotImplementedError("loss.gate_rescue is not ported")
    return cfg
