"""The port's evaluation command line (cli/eval_vsdf.py) against the JAX
package's, and end to end on the CPU.

- The parser: the same flags, destinations, defaults, types, choices and
  nargs as the JAX command line's.
- `main([...], device="cpu")` on a 16x24 DTU fixture with held-out views
  and masks, from the checkpoint a two-step port trainer at the small
  size wrote: --eval_rendering writes every eval view's and the first
  three training views' eval/normal PNGs and scaled depth PFMs into
  rendering_<epoch>/ (the renders equal `render_image` of the loaded
  parameters); --eval_mesh writes the mesh PLY; --result_from default
  reports finite PSNR and SSIM over the held-out views (LPIPS None
  without weights).
- Without a device it runs on "cuda", and without a card raises naming
  CUDA.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from s_volsdf_tpu.cli import eval_vsdf as jcli
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.cli import eval_vsdf as tcli
from s_volsdf_tpu_torch.data import io as tio
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.data.scene_dataset import load_scene
from s_volsdf_tpu_torch.engine.eval_geo import _load_mesh
from s_volsdf_tpu_torch.engine.render import render_image
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from test_torch_cli import SMALL

RES = (16, 24)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tiny-width tests run torch on one thread: its thread pool
    only contends with the other test processes at these sizes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _actions(parser):
    return sorted((tuple(a.option_strings), a.dest, a.default, a.type,
                   tuple(a.choices) if a.choices else None, a.nargs)
                  for a in parser._actions)


def test_parser_matches_jax(monkeypatch):
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    with pytest.raises(SystemExit):
        jcli.main()
    assert _actions(tcli.build_parser()) == _actions(seen["parser"])


@pytest.fixture(scope="module")
def trained_run(tmp_path_factory):
    """A 16x24 DTU fixture (2 held-out views with masks) and the run
    directory of a two-step port trainer at the small size."""
    tmp = tmp_path_factory.mktemp("eval_vsdf")
    data = str(tmp / "data")
    make_dtu_fixture(data, scan_id=106, img_res=RES, n_eval_views=2)
    overrides = SMALL + [f"dataset.img_res=[{RES[0]},{RES[1]}]",
                         "train.train_compute_dtype=float32",
                         "train.train_activation_dtype=float32"]
    cfg = tconfig.load_config("dtu", overrides=overrides)
    cfg.exps_folder = str(tmp / "exps_vsdf")
    scene = load_scene("DTU", RES, 106, 3, data)
    trainer = VolTrainer(cfg, scene, "scan106", device="cpu",
                         exps_root=str(tmp))
    trainer.run(2)
    return tmp, data, overrides, trainer


def test_eval_vsdf_end_to_end_cpu(trained_run):
    tmp, data, overrides, trainer = trained_run
    evals = str(tmp / "exps_result")
    common = ["--conf", "dtu", "--scan_ids", "106", "--exps_folder",
              trainer.cfg.exps_folder, "--evals_folder", evals,
              "--data_dir_root", data, "--override"] + overrides
    assert tcli.main(["--eval_rendering", "--eval_mesh", "--resolution", "32"]
                     + common, device="cpu") == []
    images = os.path.join(evals, "ours_106", f"rendering_{trainer.epoch}")
    scene = load_scene("DTU", RES, 106, -1, data)
    views = scene.eval_ids() + [25, 22, 28]
    for v in views:
        for name in (f"eval_{v:03d}.png", f"normal_{v:03d}.png",
                     f"depth_est/{v:08d}.pfm"):
            assert os.path.isfile(os.path.join(images, name)), name
    v = views[0]
    maps = render_image(trainer.state.params, trainer.cfg.model,
                        scene.poses[v], scene.intrinsics[v], RES)
    np.testing.assert_array_equal(
        tio.read_png(os.path.join(images, f"eval_{v:03d}.png")),
        (np.clip(maps["rgb"], 0, 1) * 255).astype(np.uint8))
    depth, _ = tio.read_pfm(os.path.join(images, f"depth_est/{v:08d}.pfm"))
    np.testing.assert_array_equal(depth, (maps["depth"] * scene.scale_factor
                                          ).astype(np.float32))
    verts, faces = _load_mesh(os.path.join(evals, "ours_106", "mesh",
                                           "scan106.ply"))
    assert verts.shape[0] > 100 and faces.shape[0] > 100
    assert np.isfinite(verts).all()

    res = tcli.main(["--eval_rendering", "--result_from", "default"] + common,
                    device="cpu")
    assert len(res) == 1 and res[0]["n_views"] == len(scene.eval_ids())
    assert np.isfinite(res[0]["psnr_mean"]) and 0 < res[0]["ssim_mean"] <= 1
    assert res[0]["lpips_mean"] is None


def test_eval_vsdf_defaults_to_cuda(trained_run, monkeypatch):
    tmp, data, overrides, trainer = trained_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["--scan_ids", "106", "--exps_folder",
                   trainer.cfg.exps_folder, "--data_dir_root", data,
                   "--eval_rendering"])
