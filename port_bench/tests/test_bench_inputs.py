"""The benchmark's torch copies of the sphere scene and of the
probability volumes, held to the repository's numpy generators."""

from __future__ import annotations

import numpy as np
import torch

from port_bench import inputs
from s_volsdf_tpu_torch.data import synthetic


def test_sphere_scene_matches_the_numpy_generator():
    want = synthetic.make_sphere_scene(3, (24, 32), sphere_radius=0.7)
    got = inputs.sphere_scene((24, 32), 0.7, "cpu", inputs.view_angles(3))
    np.testing.assert_allclose(got["poses"].numpy(), want.poses, atol=1e-6)
    np.testing.assert_allclose(got["K"].numpy(), want.intrinsics, atol=0)
    np.testing.assert_allclose(got["images"].numpy(), want.images, atol=1e-5)
    hit = np.isfinite(want.depths)
    assert (np.isfinite(got["depths"].numpy()) == hit).all()
    np.testing.assert_allclose(got["depths"].numpy()[hit], want.depths[hit],
                               rtol=1e-5)


def test_prob_volume_matches_gt_prob_volume():
    sc = synthetic.make_sphere_scene(3, (24, 32))
    D, Hc, Wc = 16, 12, 16
    dvals = np.linspace(0.5, 5.0, D).astype(np.float32)
    K = sc.intrinsics[1].copy()
    K[0, :] *= Wc / 32
    K[1, :] *= Hc / 24
    want, _ = synthetic.gt_prob_volume(sc.poses[1], K, (Hc, Wc), dvals, 1.0,
                                       sigma_intervals=1.0, floor=0.02)
    got = inputs.prob_volume(torch.as_tensor(sc.poses[1]), torch.as_tensor(K),
                             (Hc, Wc), torch.as_tensor(dvals), 0.8, 1.0, 0.02,
                             0.0, None)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-6)


def test_depth_noise_is_the_seeds_and_of_its_size():
    sc = inputs.sphere_scene((24, 32), 0.8, "cpu", inputs.view_angles(3))
    vol = {"shape": [32, 12, 16], "depth_range": [0.5, 5.0],
           "sigma_intervals": 1.0, "floor": 0.02, "depth_noise": 0.0125}
    a = inputs.volumes(sc, vol, torch.Generator().manual_seed(5))
    b = inputs.volumes(sc, vol, torch.Generator().manual_seed(5))
    c = inputs.volumes(sc, dict(vol, depth_noise=0.0), None)
    assert torch.equal(a["prob"], b["prob"])
    assert 0 < float((a["prob"] - c["prob"]).abs().max()) < 0.2
    torch.testing.assert_close(a["prob"].sum(dim=1),
                               torch.ones_like(a["prob"][:, 0]))
