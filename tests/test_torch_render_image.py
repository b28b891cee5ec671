"""The port's eval render (`engine.render.render_image`) against the JAX
package's at 12x16 pixels, fast=-1, on the small VolSDF of
test_torch_config.shrink: rgb, depth, normal and acc within 2e-4
absolute, the VolSDF render bar (README "Verified parity"), on every
pixel (measured max |diff|, params seed 6: depth 1.37e-4, normal
4.4e-5, rgb 1.7e-5, acc 2.4e-7; no pixel needed the 1%/3e-3 allowance
of the width-320 depth render). The chunk does not change the values
(rays are independent): a render in chunks of 48 rays equals one in a
single chunk to 1e-6."""

import numpy as np
import torch
import pytest

from s_volsdf_tpu.engine.render import render_image as jrender_image
from s_volsdf_tpu_torch.engine.render import render_image as trender_image
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import params_pair, small_configs
from test_torch_render import RES, _view

MAPS = {"rgb": RES + (3,), "depth": RES, "normal": RES + (3,), "acc": RES}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_render_image_matches_jax():
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=6)
    _, pose, intr = _view()
    want = jrender_image(jp, jcfg.model, pose, intr, RES, chunk=64, fast=-1)
    builds = fused_sdf.pack_sdf.builds
    got = trender_image(tp, tcfg.model, pose, intr, RES, chunk=48, fast=-1)
    # On the CPU the sweeps take the plain MLP: nothing is packed.
    assert fused_sdf.pack_sdf.builds == builds
    for name, shape in MAPS.items():
        assert got[name].shape == shape, name
        assert np.isfinite(got[name]).all(), name
        np.testing.assert_allclose(got[name], want[name], atol=2e-4,
                                   err_msg=name)
    whole = trender_image(tp, tcfg.model, pose, intr, RES, chunk=RES[0] * RES[1],
                          fast=-1)
    for name in MAPS:
        np.testing.assert_allclose(whole[name], got[name], atol=1e-6,
                                   err_msg=name)
