"""The port's 20-step training loop and feedback render on the CPU,
through the same helpers chip_smoke.py drives on the card, at the small
size of the other tests/test_torch_*.py files."""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402
from s_volsdf_tpu_torch.ops import fused_sdf  # noqa: E402
from test_torch_config import IMG_RES, VOL, shrink  # noqa: E402


def test_twenty_steps_and_feedback_render_on_cpu():
    cfg = shrink(chip_smoke.float32_dtu_config())
    trainer = chip_smoke.make_trainer(cfg, IMG_RES, VOL, "cpu")
    launches = fused_sdf.fused_sdf_values.launches
    trainer.run(chip_smoke.TRAIN_STEPS)
    losses = [lo.loss for lo in trainer.losses]
    assert len(losses) == chip_smoke.TRAIN_STEPS
    assert np.all(np.isfinite(losses))
    assert all(lo.grad_finite == 1.0 for lo in trainer.losses)
    assert any(lo.mvs_loss != 0.0 for lo in trainer.losses)
    assert len(trainer.chunk_seconds) == chip_smoke.TRAIN_STEPS
    assert trainer.state.iter_step == chip_smoke.TRAIN_STEPS
    depth = trainer.render_mvs(0, res_scale=0.5, chunk=64)
    assert depth.shape == (IMG_RES[0] // 2, IMG_RES[1] // 2)
    assert np.isfinite(depth).all()
    # On the CPU the sweep takes the plain version: no kernel launch.
    assert fused_sdf.fused_sdf_values.launches == launches
