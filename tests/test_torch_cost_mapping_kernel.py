"""cost_mapping at each `train.mvs_pack_dtype`: the port's volumes
stored in float32 or bfloat16 (`engine.train_step.pack_for_chunk`)
against the JAX package's `cost_mapping` on `pack_volumes(..., dtype)`,
its corner-cube pack in the same dtype, for the linear and the
inverse-depth slab normalisation.

Tolerances: the validity mask exact; pj and pi within 1e-5 absolute, the
MVS bar (README "Verified parity"): both sides promote the same bf16
values to float32 before their trilinear weights, and sum in another
order. The CUDA kernel (csrc/cost_mapping.cu) is held to the plain
version on the card (tests/test_torch_cuda.py, chip_smoke.py); on the
CPU the wrapper takes the plain version and launches nothing.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.ops.cost_mapping import cost_mapping as jcost
from s_volsdf_tpu.ops.cost_mapping import pack_volumes
from s_volsdf_tpu_torch.engine.train_step import pack_for_chunk
from s_volsdf_tpu_torch.ops import cost_mapping as tcm
from test_torch_config import mvs_pair, scene_and_volumes, small_configs
from test_torch_cost_mapping import _samples

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.mark.parametrize("pack_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("inverse_depth", [False, True])
@pytest.mark.parametrize("view", [0, 2])
def test_packed_volumes_match_jax(pack_dtype, inverse_depth, view):
    scene, prob, z_slab = scene_and_volumes(inverse_depth=inverse_depth)
    jm, tm = mvs_pair(scene, prob, z_slab, inverse_depth=inverse_depth)
    _, cfg = small_configs()
    cfg.train.mvs_pack_dtype = pack_dtype
    tm = pack_for_chunk(cfg, tm)
    assert tm.prob.dtype == DTYPES[pack_dtype][1]
    assert tm.z_slab.dtype == torch.float32      # the planes stay exact
    jpack = pack_volumes(jm, dtype=DTYPES[pack_dtype][0])
    z, xyz = _samples(scene, seed=11 + view)
    onehot = np.zeros(3, np.float32)
    onehot[view] = 1.0

    jpj, jpi, jvalid = jcost(jnp.asarray(z), jnp.asarray(xyz),
                             jnp.asarray(onehot), jpack)
    launches = tcm.cost_mapping.launches
    tpj, tpi, tvalid = tcm.cost_mapping(torch.tensor(z), torch.tensor(xyz),
                                        torch.tensor(onehot), tm)
    assert tcm.cost_mapping.launches == launches   # the CPU: plain version
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tpj.numpy(), np.asarray(jpj), atol=1e-5)
    np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi), atol=1e-5)
    valid = tvalid.numpy()
    assert 0 < valid.sum() < valid.size and tpj.numpy().max() > 0.05


def test_pack_dtype_is_live():
    """The bf16 store rounds the probabilities before their weights:
    pj differs from the float32 store's, by at most the rounding."""
    scene, prob, z_slab = scene_and_volumes()
    _, tm = mvs_pair(scene, prob, z_slab)
    _, cfg = small_configs()
    cfg.train.mvs_pack_dtype = "bfloat16"
    z, xyz = _samples(scene, seed=11)
    onehot = torch.tensor([1.0, 0.0, 0.0])
    f32 = tcm.cost_mapping(None, torch.tensor(xyz), onehot, tm)
    bf16 = tcm.cost_mapping(None, torch.tensor(xyz), onehot,
                            pack_for_chunk(cfg, tm))
    assert not torch.equal(f32[0], bf16[0])
    assert torch.equal(f32[2], bf16[2])      # the masks use the planes only
    assert (f32[0] - bf16[0]).abs().max() <= 2.0 ** -8 * 2 * f32[0].max()


def test_touched_bytes_counts_sectors():
    """The bound's bytes: at least each sample's own input and output,
    at most eight 32-byte sectors per sample and view plus those; a
    bf16 volume touches no more sectors than the float32 one."""
    scene, prob, z_slab = scene_and_volumes()
    _, tm = mvs_pair(scene, prob, z_slab)
    _, cfg = small_configs()
    cfg.train.mvs_pack_dtype = "bfloat16"
    _, xyz = _samples(scene, seed=11)
    xyz = torch.tensor(xyz)
    n = xyz.shape[0] * xyz.shape[1]
    f32 = tcm.touched_bytes(xyz, tm)
    bf16 = tcm.touched_bytes(xyz, pack_for_chunk(cfg, tm))
    assert 21 * n < bf16 <= f32 <= 21 * n + 3 * n * 16 * tcm.SECTOR
