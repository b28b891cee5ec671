"""Parameters cross between the JAX package and the port exactly."""

import jax
import numpy as np
import torch

from s_volsdf_tpu.models.network import init_volsdf_params as jinit
from s_volsdf_tpu_torch.bridge import from_jax_params, to_jax_params
from s_volsdf_tpu_torch.models.network import init_volsdf_params as tinit
from test_torch_config import small_configs


def _assert_trees_equal(a, b):
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    assert ta == tb
    for x, y in zip(la, lb):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_round_trip_is_exact():
    jcfg, _ = small_configs()
    p = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg.model))
    _assert_trees_equal(to_jax_params(from_jax_params(p)), p)


def test_port_init_has_jax_layout():
    """The port's own init gives the JAX pytree's structure, shapes and
    the init's invariants (W == g*v/||v|| at init, beta = beta_init)."""
    jcfg, tcfg = small_configs()
    jp = jax.tree.map(np.asarray, jinit(jax.random.PRNGKey(0), jcfg.model))
    tp = tinit(torch.Generator().manual_seed(0), tcfg.model)
    tree = to_jax_params(tp)
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    for x, y in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        assert x.shape == y.shape
    for layer in tree["sdf"] + tree["rgb"]:
        np.testing.assert_allclose(np.linalg.norm(layer["v"], axis=0),
                                   layer["g"], rtol=1e-6)
    assert tree["density"]["beta"] == np.float32(jcfg.model.density.beta_init)
    # Geometric init: the first layer reads xyz only; the skip layer
    # ignores the encoded part of the concatenated input.
    assert not tree["sdf"][0]["v"][3:].any()
    d_pe = 3 * (1 + 2 * jcfg.model.implicit.multires)
    assert not tree["sdf"][2]["v"][-(d_pe - 3):].any()
