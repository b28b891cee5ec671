"""The port's cost_mapping (direct gathers on the unpacked volume)
against the JAX package's (corner-cube pack) on f32 MVSVolumes, with
the linear and the inverse-depth slab normalisation.

Tolerances: pj and pi within 1e-5 absolute, the MVS bar of the JAX
package (README "Verified parity"); the validity mask exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu.ops.cost_mapping import cost_mapping as jcost
from s_volsdf_tpu_torch.ops.cost_mapping import cost_mapping as tcost
from test_torch_config import mvs_pair, scene_and_volumes

R, S = 64, 20


def _samples(scene, seed):
    """xyz (R, S, 3) along rays of view 0 at z in [0.3, 5.5]: inside and
    outside the slab, in front of and behind some of the cameras."""
    rng = np.random.default_rng(seed)
    H, W = scene.img_res
    K, c2w = scene.intrinsics[0], scene.poses[0]
    px = np.stack([rng.uniform(-4, W + 4, R), rng.uniform(-4, H + 4, R)], -1)
    d_cam = np.stack([(px[:, 0] - K[0, 2]) / K[0, 0],
                      (px[:, 1] - K[1, 2]) / K[1, 1], np.ones(R)], -1)
    d = d_cam @ c2w[:3, :3].T
    z = np.sort(rng.uniform(0.3, 5.5, (R, S)), axis=1)
    xyz = c2w[:3, 3] + z[..., None] * d[:, None, :]
    return z.astype(np.float32), xyz.astype(np.float32)


@pytest.mark.parametrize("inverse_depth", [False, True])
@pytest.mark.parametrize("view", [0, 2])
def test_cost_mapping_matches_jax(inverse_depth, view):
    scene, prob, z_slab = scene_and_volumes(inverse_depth=inverse_depth)
    jm, tm = mvs_pair(scene, prob, z_slab, inverse_depth=inverse_depth)
    z, xyz = _samples(scene, seed=11 + view)
    onehot = np.zeros(3, np.float32)
    onehot[view] = 1.0

    jpj, jpi, jvalid = jcost(jnp.asarray(z), jnp.asarray(xyz),
                             jnp.asarray(onehot), jm)
    tpj, tpi, tvalid = tcost(torch.tensor(z), torch.tensor(xyz),
                             torch.tensor(onehot), tm)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tpj.numpy(), np.asarray(jpj), atol=1e-5)
    np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi), atol=1e-5)
    # The case is informative: some samples valid, some not, mass > 0.
    valid = tvalid.numpy()
    assert 0 < valid.sum() < valid.size
    assert tpj.numpy().max() > 0.05


@pytest.mark.parametrize("n_views", [2, 4])
def test_cost_mapping_any_views_matches_jax(n_views):
    """Other view counts than 3 (the JAX package takes any number of
    training views): the plain version, which sums the views one by one
    in the kernel's order, against JAX's sums at the same bars."""
    scene, prob, z_slab = scene_and_volumes(n_views=n_views)
    jm, tm = mvs_pair(scene, prob, z_slab)
    z, xyz = _samples(scene, seed=11)
    onehot = np.zeros(n_views, np.float32)
    onehot[n_views - 1] = 1.0
    jpj, jpi, jvalid = jcost(jnp.asarray(z), jnp.asarray(xyz),
                             jnp.asarray(onehot), jm)
    tpj, tpi, tvalid = tcost(torch.tensor(z), torch.tensor(xyz),
                             torch.tensor(onehot), tm)
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    np.testing.assert_allclose(tpj.numpy(), np.asarray(jpj), atol=1e-5)
    np.testing.assert_allclose(tpi.numpy(), np.asarray(jpi), atol=1e-5)
    valid = tvalid.numpy()
    assert 0 < valid.sum() < valid.size
