"""The port's multi-device scene pipeline on the CPU, ranks over gloo as
in tests/test_torch_parallel.py: the cascade one view a rank (against
the serial stage and the JAX package's view-sharded `stage_all_views`),
the command line at 2 ranks, the fusion pool, and the dry run.

Tolerances: the view-sharded stages equal the serial ones to the bit
(the same program on each view); against JAX's stage 0 the bars of
tests/test_cascade_view_shard.py and test_torch_runner.py
(`assert_stage_matches`, 1e-5).
"""

import filecmp
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from s_volsdf_tpu import config as jconfig
from s_volsdf_tpu.engine import runner as jrunner
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.data.fixtures import make_dtu_fixture
from s_volsdf_tpu_torch.engine import runner as trunner
from s_volsdf_tpu_torch.parallel import mesh as pmesh
from s_volsdf_tpu_torch.tools import dryrun_multichip
from test_cascade_view_shard import _make_sc
from test_torch_cli import SMALL
from test_torch_fusion import _sphere_views, write_scene_outputs
from test_torch_runner import (RES, _configure, assert_stage_matches,
                               lively_checkpoint)

import torch_parallel_ranks as ranks

MODELS = ("casmvsnet", "transmvsnet")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread, as each rank has, and subnormals flushed, as the
    ranks of the command line flush them (the feedback renders' softplus
    makes them, and the CPU takes them slowly)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pipeline") / "data")
    make_dtu_fixture(root, scan_id=106, img_res=RES)
    return root


@pytest.fixture(scope="module")
def cascades(data_root, tmp_path_factory):
    """Each model's stages: the port's serial run here, and one view a
    rank on 3 ranks."""
    out = tmp_path_factory.mktemp("ckpt")
    models = {}
    for m in MODELS:
        ck = lively_checkpoint(data_root, m, str(out / m))
        cfg = _configure(tconfig.dtu_config(), data_root, (0, 0, 0))
        cfg.mvs.model_name = m
        models[m] = (cfg, ck)
    serial = {m: ranks.cascade_stages(cfg, ck, data_root)
              for m, (cfg, ck) in models.items()}
    sharded = pmesh.run_local_ranks(
        ranks.cascade_checks, 3, {"models": models, "data": data_root},
        timeout=300)
    return models, serial, sharded


@pytest.mark.parametrize("model", MODELS)
def test_view_sharded_cascade_equals_serial(cascades, model):
    """Three stages of each view, one view a rank: every rank holds every
    view's outputs and extras, equal to the serial stages to the bit."""
    _, serial, sharded = cascades
    for r in sharded:
        for stage, (got, want) in enumerate(zip(r[model], serial[model])):
            for v, ((go, ge), (wo, we)) in enumerate(zip(got, want)):
                for k in wo:
                    np.testing.assert_array_equal(
                        go[k], wo[k], err_msg=f"stage {stage} view {v} {k}")
                if we is None:
                    assert ge is None
                else:
                    np.testing.assert_array_equal(ge, we)


@pytest.mark.parametrize("model", MODELS)
def test_view_sharded_cascade_matches_jax(cascades, data_root, model):
    """Stage 0 one view a rank against the JAX package's view-sharded
    stage_all_views (one view a device on 3 of its CPU devices)."""
    models, _, sharded = cascades
    _, ck = models[model]
    jcfg = _configure(jconfig.dtu_config(), data_root, (0, 0, 0))
    jcfg.mvs.model_name = model
    jcfg.parallel.shard_mvs_views = True
    assert jrunner._view_mesh(jcfg, 3) is not None
    engine = jrunner.MVSEngine(jcfg, weights_path=ck)
    want, _ = jrunner.run_mvs_stage(jcfg, engine,
                                    _make_sc(jcfg, os.path.dirname(data_root)),
                                    0)
    for v, (got, _) in enumerate(sharded[0][model][0]):
        assert_stage_matches(got, {k: np.asarray(want[v][k]) for k in got},
                             model)


CLI_RES = (32, 64)


def test_cli_two_ranks(tmp_path):
    """cli.run at 2 ranks on a 32x64 fixture (fewer ranks than views: the
    cascade runs serially on each, with a warning; the renders shard
    their rays)
    writes each output once, from the first rank; with
    parallel.shard_rays=false its depth maps equal a one-process run's
    to the bit."""
    data_root = str(tmp_path / "data")
    make_dtu_fixture(data_root, scan_id=106, img_res=CLI_RES)

    def argv(out):
        return ([f"outdir={out}/exps", f"exps_folder={out}/vsdf",
                 "testlist=scan106", f"data_dir_root={data_root}",
                 f"dataset.data_dir_root={data_root}", "max_h=32",
                 "max_w=64", "dataset.img_res=[32,64]",
                 "mvs.ndepths=[16,8,8]", "mvs.numdepth=16",
                 "mvs.x2_mvsres=false", "opt_stepNs=[2,0,0]",
                 "parallel.shard_rays=false", "train.render_freq=-1",
                 "model.sampler.max_total_iters=2"] + SMALL)
    two, one = str(tmp_path / "two"), str(tmp_path / "one")
    from s_volsdf_tpu_torch.cli import run as trun
    with ThreadPoolExecutor(1) as pool:   # the one-process run meanwhile
        solo = pool.submit(trun.main, argv(one), device="cpu")
        r0, r1 = pmesh.run_local_ranks(
            ranks.cli_checks, 2, {"argv": argv(two), "root": two},
            timeout=300)
        solo.result()
    assert r1["written"] == []
    # The trainer's "latest" is rewritten at the end of a run, as in one
    # process; every other file is written once.
    outputs = [p for p in r0["written"] if "checkpoints" not in p]
    assert len(outputs) == len(set(outputs)), outputs
    assert r0["plys"] == r1["plys"] and os.path.exists(r0["plys"][0])
    kinds = {os.path.basename(os.path.dirname(p)) for p in r0["written"]}
    assert {"depth_est", "confidence", "cams", "images"} <= kinds
    assert any(p.endswith("_l3.ply") for p in r0["written"])
    pfms = [p for p in r0["written"] if p.endswith(".pfm")]
    assert len(pfms) == 6
    for p in pfms:
        assert filecmp.cmp(os.path.join(two, p), os.path.join(one, p),
                           shallow=False), p


def test_pcd_filter_pool_matches_serial(tmp_path):
    """pcd_filter over cfg.num_worker=2 spawned workers writes the serial
    run's point clouds."""
    _, views = _sphere_views()
    plys = {}
    for workers in (1, 2):
        out = tmp_path / f"w{workers}"
        for scan in ("scan106", "scan114"):
            write_scene_outputs(str(out / scan), views, jpeg=False)
        cfg = tconfig.load_config("dtu", [f"outdir={out}",
                                          f"num_worker={workers}",
                                          "filter.eval_mask=false"])
        plys[workers] = trunner.pcd_filter(cfg, ["scan106", "scan114"],
                                           exps_root="", device="cpu")
    for a, b in zip(plys[1], plys[2]):
        assert filecmp.cmp(a, b, shallow=False), (a, b)


def test_dryrun_multichip_two_ranks(capsys):
    assert dryrun_multichip.main(["--n", "2", "--timeout", "300"]) == 0
    assert "dryrun_multichip ok on 2 ranks" in capsys.readouterr().out
