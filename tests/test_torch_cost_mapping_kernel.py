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

import dataclasses

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


def test_packed_bytes_counts_sectors():
    """The bound's bytes on the kernel's corner-block copies: each
    sample's own input and output, and at most one volume sector and one
    near/far sector per sample and view (the 8 corners of a cube, the 4
    of a 2 x 2 block of planes, are one sector each)."""
    scene, prob, z_slab = scene_and_volumes()
    _, tm = mvs_pair(scene, prob, z_slab)
    _, xyz = _samples(scene, seed=11)
    xyz = torch.tensor(xyz)
    n = xyz.shape[0] * xyz.shape[1]
    for dtype in (torch.float32, torch.bfloat16):
        mvs = dataclasses.replace(tm, prob=tm.prob.to(dtype))
        got = tcm.packed_bytes(xyz, mvs)
        assert 21 * n < got <= 21 * n + 3 * n * 2 * tcm.SECTOR
        assert (got - 21 * n) % tcm.SECTOR == 0


def test_pack_for_chunk_checks_volumes_once():
    """The trainer's store validates the volumes and gives them the
    kernel's copy, explicitly, in their `kernel` field; storing them
    again makes no second copy; a copy kept through a replaced tensor or
    setting is seen as stale; `check_volumes` then makes a fresh one."""
    scene, prob, z_slab = scene_and_volumes()
    _, tm = mvs_pair(scene, prob, z_slab)
    assert tm.kernel is None
    _, cfg = small_configs()
    cfg.train.mvs_pack_dtype = "bfloat16"
    tm = pack_for_chunk(cfg, tm)
    chk = tm.kernel
    assert chk.made_from(tm) and chk.V == 3 and chk.device == tm.prob.device
    assert pack_for_chunk(cfg, tm) is tm and tcm.check_volumes(tm) is tm
    a = chk.args
    assert (a.V, a.D, a.Hv, a.Wv) == tuple(tm.prob.shape)
    assert a.group == 3 and a.prob_bf16 == 1 and a.inverse_depth == 0
    assert a.prob8 == chk.packed[0].data_ptr()
    assert a.slab8 == chk.packed[1].data_ptr()
    assert chk.packed[0].dtype == torch.bfloat16
    H, W = scene.img_res
    assert a.u_scale == pytest.approx(2.0 / (W - 1), rel=1e-7)
    assert a.v_scale == pytest.approx(2.0 / (H - 1), rel=1e-7)
    for stale in (dataclasses.replace(tm, z_slab=tm.z_slab * 2.0),
                  dataclasses.replace(tm, inverse_depth=True)):
        assert stale.kernel is chk and not chk.made_from(stale)
    stale = dataclasses.replace(tm, z_slab=tm.z_slab * 2.0)
    again = tcm.check_volumes(stale).kernel
    assert again is not chk
    assert torch.equal(again.packed[1], tcm.slab_cubes(stale.z_slab))
    assert again.args.slab8 == again.packed[1].data_ptr()


@pytest.mark.parametrize("change,match", [
    ("z_slab", "z_slab of shape"),
    ("prob_dtype", "prob must be float32 or bfloat16"),
    ("intrinsics_dtype", "intrinsics must be"),
    ("c2w_strided", "c2w must be contiguous"),
    ("img_res", "img_res"),
    ("views", "views"),
])
def test_check_volumes_refuses(change, match):
    """What the kernel does not take raises when the volumes are checked,
    before any launch."""
    scene, prob, z_slab = scene_and_volumes()
    _, tm = mvs_pair(scene, prob, z_slab)
    if change == "z_slab":
        tm.z_slab = tm.z_slab[:, :, :-1].contiguous()
    elif change == "prob_dtype":
        tm.prob = tm.prob.to(torch.float16)
    elif change == "intrinsics_dtype":
        tm.intrinsics = tm.intrinsics.double()
    elif change == "c2w_strided":
        tm.c2w = tm.c2w.transpose(1, 2)
    elif change == "img_res":
        tm.img_res = (1, scene.img_res[1])
    else:
        V = tcm.MAX_VIEWS + 1
        tm.prob = torch.zeros((V, 2, 2, 2))
        tm.z_slab = torch.zeros((V, 2, 2, 2))
        tm.intrinsics = tm.c2w = torch.zeros((V, 4, 4))
    with pytest.raises(ValueError, match=match):
        tcm.check_volumes(tm)


def test_corner_packs_layout():
    """The kernel's packed copies: at each (z, y, x), the cube's corner
    (by, bx, bz) at (by * 2 + bx) * 2 + bz, each index clamped at the
    end of its axis; at each pixel of the planes, its 2 x 2 block's
    (near, far) at (by * 2 + bx) * 2 + plane."""
    scene, prob, z_slab = scene_and_volumes()
    _, tm = mvs_pair(scene, prob, z_slab)
    vol8, nf8 = tcm.check_volumes(tm).kernel.packed
    V, D, H, W = tm.prob.shape
    assert vol8.shape == (V, D, H, W, 8) and nf8.shape == (V, H, W, 8)
    v, z, y, x = torch.meshgrid(*(torch.arange(k) for k in (V, D, H, W)),
                                indexing="ij")
    for by in (0, 1):
        for bx in (0, 1):
            yb = torch.clamp(y + by, max=H - 1)
            xb = torch.clamp(x + bx, max=W - 1)
            for bz in (0, 1):
                want = tm.prob[v, torch.clamp(z + bz, max=D - 1), yb, xb]
                assert torch.equal(vol8[..., (by * 2 + bx) * 2 + bz], want)
            for plane in (0, 1):
                want = tm.z_slab[v[:, 0], plane, yb[:, 0], xb[:, 0]]
                assert torch.equal(nf8[..., (by * 2 + bx) * 2 + plane], want)
