"""The port's feedback depth render against the JAX package's, at 12x16
pixels and fast=-1 (the full eval schedule), and the trainer's
feedback map built from it.

Tolerance 2e-4 absolute on depth and acc, the VolSDF render bar of the
JAX package (README "Verified parity").
"""

import numpy as np
import pytest
import torch

from s_volsdf_tpu.engine.render import render_depth as jrender_depth
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
from s_volsdf_tpu_torch.engine.render import render_depth as trender_depth
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from s_volsdf_tpu_torch.ops import fused_sdf
from test_torch_config import (OUTSIDE_FAMILY, outside_configs, params_pair,
                               small_configs)

RES = (12, 16)


def _view():
    scene = make_sphere_scene(3, (24, 32))
    intr = scene.intrinsics[0].copy()
    intr[:2] *= 0.5                       # the 24x32 camera at 12x16
    return scene, scene.poses[0], intr


def test_render_depth_matches_jax():
    jcfg, tcfg = small_configs()
    jp, tp = params_pair(jcfg, seed=6)
    _, pose, intr = _view()
    want = jrender_depth(jp, jcfg.model, pose, intr, RES, chunk=64, fast=-1)
    got = trender_depth(tp, tcfg.model, pose, intr, RES, chunk=64, fast=-1)
    for name in ("depth", "acc"):
        assert got[name].shape == RES
        np.testing.assert_allclose(got[name], want[name], atol=2e-4,
                                   err_msg=name)
    assert np.isfinite(got["depth"]).all()


# Depth pixels of the width-320 render allowed past the 2e-4 bar, and
# the bar they are held to instead. At that width the render is
# ill-conditioned in the JAX package itself: multiplying its SDF by
# 1 + 1.2e-7 sin(k (x + 2y + 3z)) (one float32 ulp) moves its own depth
# by up to 1.1e-3, on up to 4 of the 192 pixels (parameter seeds 1, 4
# and 6, three k each); with the JAX SDF values fed to the port's
# sampler, the port's depth still differs from JAX's by 7.8e-4 on 4
# pixels (seed 6): the sampler's float32 sums in another order, not the
# SDF, decide them.
ILL_CONDITIONED = {"width320": (6, 3e-3), "skip24": (0, 2e-4)}


@pytest.mark.parametrize("family", sorted(OUTSIDE_FAMILY))
def test_render_depth_matches_jax_outside_family(family):
    """An SDF MLP outside the fused kernel's family (width 320; skips at
    2 and 4) renders through the plain MLP, packs nothing, and matches
    the JAX package: acc within 2e-4, depth within 2e-4 but on the
    pixels ILL_CONDITIONED allows, which are held to its second bar."""
    jcfg, tcfg = outside_configs(family)
    assert not fused_sdf.supported(tcfg.model)
    jp, tp = params_pair(jcfg, seed=6)
    _, pose, intr = _view()
    want = jrender_depth(jp, jcfg.model, pose, intr, RES, chunk=64, fast=-1)
    builds, sweeps = fused_sdf.pack_sdf.builds, fused_sdf.plain_sweeps
    got = trender_depth(tp, tcfg.model, pose, intr, RES, chunk=64, fast=-1)
    assert fused_sdf.pack_sdf.builds == builds
    assert fused_sdf.plain_sweeps > sweeps
    assert got["depth"].shape == got["acc"].shape == RES
    np.testing.assert_allclose(got["acc"], want["acc"], atol=2e-4)
    err = np.abs(got["depth"] - want["depth"])
    n_past, bar = ILL_CONDITIONED[family]
    assert int((err > 2e-4).sum()) <= n_past and err.max() <= bar, (
        int((err > 2e-4).sum()), err.max())
    assert np.isfinite(got["depth"]).all()


def test_render_mvs_far_mask():
    """Depth * scale_factor, with pixels of acc < 0.2 pushed to the far
    (largest) depth."""
    jcfg, tcfg = small_configs()
    _, tp = params_pair(jcfg, seed=6)
    scene, pose, intr = _view()
    trainer = VolTrainer(tcfg, scene_from_synthetic(scene), device="cpu")
    trainer.state.params.load_state_dict(tp.state_dict())
    trainer.scale_factor = 2.0
    got = trainer.render_mvs(0, res_scale=0.5, chunk=64)
    maps = trender_depth(tp, tcfg.model, pose, intr, RES, chunk=64,
                         fast=-1, gen=torch.Generator().manual_seed(0))
    depth = maps["depth"] * 2.0
    want = np.where(maps["acc"] < 0.2, depth.max(), depth)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got.dtype == np.float32 and got.shape == RES
