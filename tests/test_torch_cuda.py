"""The port's CUDA kernel against its plain PyTorch version, and the
CasMVSNet cascade on the card against the same cascade on the CPU.

Every test here needs an NVIDIA GPU (and nvcc for the kernel); without
one it skips with the reason. On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda

This file imports no JAX (the card's machine need not have it).
"""

import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from s_volsdf_tpu_torch import config as tconfig  # noqa: E402
from s_volsdf_tpu_torch.models.network import init_volsdf_params  # noqa: E402
from s_volsdf_tpu_torch.ops import fused_sdf  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the fused SDF kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("n", [700, 65536, 65537, 2097152])
def test_kernel_matches_plain(cuda, n):
    """Full dtu width, up to one render launch (16,384 rays x 128) and
    with a ragged last block. Tolerance 1e-4: the kernel's bf16 x 3
    split (about 2^-16 of each product) and float32 sums in another
    order across 9 layers."""
    cfg = tconfig.dtu_config()
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                cuda)
    pts = torch.tensor(np.random.default_rng(1).normal(size=(n, 3)),
                       dtype=torch.float32, device=cuda)
    before = fused_sdf.fused_sdf_values.launches
    got = fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0)
    torch.cuda.synchronize()
    assert fused_sdf.fused_sdf_values.launches == before + 1
    ref = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts, 3.0)
    assert got.shape == (n,)
    assert torch.max(torch.abs(got - ref)).item() <= 1e-4


@pytest.mark.parametrize("dims,skip_in,multires,bounding_sphere", [
    ((32,) * 4, (2,), 4, 3.0),      # the CPU tests' small size
    ((64,) * 3, (), 2, 0.0),        # no skip junction, no clamp
    ((102,) * 5, (3,), 10, 3.0),    # widths that are not multiples of 4
    ((64,) * 3, (3,), 4, 3.0),      # the skip junction feeds the SDF layer
])
def test_kernel_family_matches_plain(cuda, dims, skip_in, multires,
                                     bounding_sphere):
    """Other members of the family `supported` names: the padding of
    odd widths, the skip junction's placement, the clamp switched off."""
    cfg = tconfig.dtu_config()
    imp = cfg.model.implicit
    imp.dims, imp.skip_in, imp.multires = dims, skip_in, multires
    cfg.model.feature_vector_size = 16
    assert fused_sdf.supported(cfg.model)
    params = init_volsdf_params(torch.Generator().manual_seed(1), cfg.model,
                                cuda)
    pts = torch.tensor(np.random.default_rng(2).normal(size=(1000, 3)),
                       dtype=torch.float32, device=cuda)
    got = fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts,
                                     bounding_sphere)
    ref = fused_sdf.sdf_values_plain(params.sdf, cfg.model, pts,
                                     bounding_sphere)
    assert torch.max(torch.abs(got - ref)).item() <= 1e-4


def test_unsupported_config_raises(cuda):
    cfg = tconfig.dtu_config()
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                cuda)
    cfg.model.implicit.skip_in = (2, 4)
    pts = torch.zeros((64, 3), device=cuda)
    with pytest.raises(ValueError, match="family"):
        fused_sdf.fused_sdf_values(params.sdf, cfg.model, pts, 3.0)


def test_cascade_stages_match_cpu(cuda, tmp_path):
    """The three CasMVSNet stages of one 64x96 view, D = 16/8/8, on the
    card and on the CPU with the same bridged weights, each fed the same
    previous depth. prob_volume within 1e-4, depth within 1e-5 relative
    (cuDNN's float32 convs sum in another order than the CPU's)."""
    errs = chip_smoke.cascade_card_vs_cpu(cuda, str(tmp_path / "data"))
    assert errs["prob"] <= chip_smoke.PROB_TOL, errs
    assert errs["depth_rel"] <= chip_smoke.DEPTH_RTOL, errs
