"""s_volsdf_tpu_torch — the PyTorch/CUDA port of s_volsdf_tpu for one
NVIDIA H100.

Modules mirror the JAX package's paths and function names
(`s_volsdf_tpu/models/sampler.py` -> `s_volsdf_tpu_torch/models/sampler.py`),
so each function's reference sits at the same place. The JAX package is
the reference the port is tested against; this package imports torch
and never JAX.

Ported so far: the VolSDF training step (sampler, SDF/radiance MLPs,
cost_mapping, loss, NaN guard, clip + Adam), the trainer's step loop and
the feedback depth render. The sampler's no-grad SDF sweep runs through
the hand-written CUDA kernel in `csrc/fused_sdf.cu`.
"""

__version__ = "0.1.0"
