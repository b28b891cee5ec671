"""The port's feedback depth render against the JAX package's, at 12x16
pixels and fast=-1 (the full eval schedule), and the trainer's
feedback map built from it.

Tolerance 2e-4 absolute on depth and acc, the VolSDF render bar of the
JAX package (README "Verified parity").
"""

import numpy as np
import torch

from s_volsdf_tpu.engine.render import render_depth as jrender_depth
from s_volsdf_tpu_torch.data.scene_dataset import scene_from_synthetic
from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
from s_volsdf_tpu_torch.engine.render import render_depth as trender_depth
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from test_torch_config import params_pair, small_configs

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
