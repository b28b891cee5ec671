"""The port's checkpoint converter (s_volsdf_tpu_torch/tools/convert_ckpt.py)
against the JAX package's (tools/convert_ckpt.py), on reference state
dicts made by `data.fixtures.reference_state_dict` from seeded weights
(the published checkpoints are not in the repository):

- `reference_state_dict` is the converters' inverse: JAX's `convert` of
  it gives the tree back, leaf for leaf (dtype, shape, bits), for the
  five models and both VolSDF weight-norm key styles; the port's
  `convert` gives JAX's;
- the port's command line, run in a process where `import jax` fails,
  writes state.npz and meta.json equal to what JAX's `save_state` writes
  of JAX's `convert`, leaf by leaf by name, bit for bit; JAX's
  `load_state` and the port's loaders (`MVSEngine(weights_path=)`,
  `load_lpips`, `bridge.load_volsdf_checkpoint`) read them;
- with those weights, each cascade's stage 0 on the 64x96 fixture of
  tests/test_torch_runner.py is within the cascade tests' bars of JAX's
  (prob 1e-5; depth 1e-5 relative, TransMVSNet's winner-take-all depth
  on the sure pixels), LPIPS within 1e-5 relative of JAX's, and the
  VolSDF SDF within the render bar, 2e-4;
- a DCN without a bias key converts to a zero bias, as in JAX; a
  checkpoint that pickles other objects than tensors fails in
  `torch.load(weights_only=True)`.
"""

import argparse
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s_volsdf_tpu import config as jconfig
from s_volsdf_tpu.models import lpips as jlpips
from s_volsdf_tpu.models import network as jnetwork
from s_volsdf_tpu.utils import checkpoint as jckpt
from s_volsdf_tpu_torch import config as tconfig
from s_volsdf_tpu_torch.bridge import (load_volsdf_checkpoint,
                                       to_jax_mvs_params)
from s_volsdf_tpu_torch.engine import runner as trunner
from s_volsdf_tpu_torch.data.fixtures import (reference_checkpoint,
                                              reference_state_dict)
from s_volsdf_tpu_torch.models import lpips as tlpips
from s_volsdf_tpu_torch.models.network import (init_volsdf_params,
                                               sdf_values)
from s_volsdf_tpu_torch.tools import convert_ckpt as tconvert
from test_torch_config import lively_mvs_tree
from test_torch_runner import (MVS_TOL, RES, _configure,
                               assert_stage_matches,
                               data_root,  # noqa: F401 (the shared fixture)
                               engines, first_sample)
from tools import convert_ckpt as jconvert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MVS_MODELS = ("casmvsnet", "ucsnet", "transmvsnet")
MODELS = MVS_MODELS + ("volsdf", "lpips")
WN_STYLES = ("weight_norm", "parametrizations")
SDF_TOL = 2e-4      # the VolSDF render bar (README "Verified parity")
LPIPS_RTOL = 1e-5   # tests/test_torch_eval_nvs.py


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees(data_root):  # noqa: F811
    """Seeded weight trees in the JAX layout: each cascade the port
    engine's init made lively (random BN, He's gain, random DCN offset
    convs), the JAX LPIPS init, the JAX VolSDF init at the dtu widths."""
    out = {}
    for model in MVS_MODELS:
        tcfg = _configure(tconfig.dtu_config(), data_root, (0, 0, 0))
        tcfg.mvs.model_name = model
        net = trunner.MVSEngine(tcfg, device="cpu").net
        out[model] = lively_mvs_tree(to_jax_mvs_params(net),
                                     np.random.default_rng(0))
    out["lpips"] = jax.tree.map(
        np.asarray, jlpips.init_lpips_params(jax.random.PRNGKey(0)))
    out["volsdf"] = jax.tree.map(np.asarray, jnetwork.init_volsdf_params(
        jax.random.PRNGKey(1), jconfig.dtu_config().model))
    return out


def _named(tree, prefix=""):
    if isinstance(tree, (dict, list)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(_named(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def assert_trees_equal(got, want):
    a, b = _named(got), _named(want)
    assert sorted(a) == sorted(b)
    for name, y in b.items():
        x = a[name]
        assert x.dtype == y.dtype and x.shape == y.shape, name
        np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("model", MODELS)
def test_inverse_round_trip_and_convert_match_jax(trees, model):
    styles = WN_STYLES if model == "volsdf" else ("weight_norm",)
    for style in styles:
        sd = reference_state_dict(model, trees[model], wn_style=style)
        want = jconvert.convert(model, sd)
        assert_trees_equal(want, trees[model])
        assert_trees_equal(tconvert.convert(model, sd), want)


@pytest.mark.parametrize("style", WN_STYLES)
def test_background_volsdf_round_trip(style):
    from s_volsdf_tpu.models.network_bg import init_volsdf_bg_params
    tree = jax.tree.map(np.asarray, init_volsdf_bg_params(
        jax.random.PRNGKey(2), jconfig.bmvs_config().model))
    sd = reference_state_dict("volsdf", tree, wn_style=style)
    want = jconvert.convert("volsdf", sd, with_background=True)
    assert_trees_equal(want, tree)
    assert_trees_equal(tconvert.convert("volsdf", sd, with_background=True),
                       want)


def test_missing_dcn_bias_converts_to_zero(trees):
    sd = reference_state_dict("transmvsnet", trees["transmvsnet"])
    dropped = [k for k in sd if k.startswith("feature.out")
               and k.endswith(".bias") and f"{k[:-5]}.conv_offset_mask.weight"
               in sd]
    assert len(dropped) == 9
    for k in dropped:
        del sd[k]
    want = jconvert.convert("transmvsnet", sd)
    got = tconvert.convert("transmvsnet", sd)
    assert_trees_equal(got, want)
    assert not np.any(got["feature"]["out1"]["dcn1"]["b"])


@pytest.fixture(scope="module")
def converted(trees, tmp_path_factory):
    """Every model written as the reference's checkpoint and converted by
    the port's command line in one process without JAX (VolSDF as a bare
    state dict in both key styles), and by JAX's `convert` +
    `save_state`: {name: (model, port directory, JAX directory)}."""
    root = tmp_path_factory.mktemp("convert")
    jobs = {}
    for model in MODELS:
        for style in (WN_STYLES if model == "volsdf" else (None,)):
            name = model if style is None else f"volsdf_{style}"
            src = str(root / f"{name}.ckpt")
            if style is None:
                ck = reference_checkpoint(model, trees[model])
                sd = ck["model"]
            else:
                ck = sd = reference_state_dict(model, trees[model],
                                               wn_style=style)
            torch.save(ck, src)
            jdir = str(root / f"{name}_jax")
            jckpt.save_state(jdir, jconvert.convert(model, sd), model=model)
            jobs[name] = (model, src, str(root / f"{name}_port"), jdir)
    argvs = [["--model", m, "--ckpt", src, "--out", out]
             for m, src, out, _ in jobs.values()]
    code = ("import sys, json; sys.modules['jax'] = None\n"
            "from s_volsdf_tpu_torch.tools import convert_ckpt\n"
            "for argv in json.loads(sys.argv[1]):\n"
            "    convert_ckpt.main(argv)\n"
            "assert 'jax' not in sys.modules or sys.modules['jax'] is None\n")
    proc = subprocess.run([sys.executable, "-c", code, json.dumps(argvs)],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("converted ") == len(jobs)
    return {name: (m, out, jdir) for name, (m, _, out, jdir) in jobs.items()}


def test_command_line_writes_what_jax_writes(converted):
    for name, (model, port_dir, jax_dir) in converted.items():
        with np.load(os.path.join(port_dir, "state.npz")) as a, \
                np.load(os.path.join(jax_dir, "state.npz")) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in b.files:
                assert a[k].dtype == b[k].dtype, (name, k)
                assert a[k].shape == b[k].shape, (name, k)
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")
        for d in (port_dir, jax_dir):
            with open(os.path.join(d, "meta.json")) as f:
                assert json.load(f) == {"model": model}


def test_jax_loads_the_port_files(converted, trees):
    for name, (model, port_dir, _) in converted.items():
        got, meta = jckpt.load_state(port_dir, trees[model])
        assert meta == {"model": model}
        assert_trees_equal(jax.tree.map(np.asarray, got), trees[model])


@pytest.mark.parametrize("model", MVS_MODELS)
def test_stage0_from_converted_weights_matches_jax(converted, data_root,  # noqa: F811
                                                   trees, model):
    port_dir = converted[model][1]
    jeng, teng = engines(data_root, model, port_dir)
    assert_trees_equal(to_jax_mvs_params(teng.net), trees[model])
    s = first_sample(data_root)
    proj, dvals = s.proj_matrices["stage1"], s.depth_values
    jf = jeng.sample_features(jeng.scene_feature_cache(jnp.asarray(s.imgs)),
                              [0, 1, 2])
    want, _ = jeng.stage(0, jf, jnp.asarray(proj), jnp.asarray(dvals), None,
                         None, RES, inverse_depth=False)
    tf = teng.sample_features(teng.scene_feature_cache(s.imgs), [0, 1, 2])
    got, _ = teng.stage(0, tf, proj, dvals, None, None, RES,
                        inverse_depth=False)
    assert_stage_matches({k: v.numpy() for k, v in got.items()},
                         {k: np.asarray(v) for k, v in want.items()},
                         model, MVS_TOL, MVS_TOL)


def test_lpips_from_converted_weights_matches_jax(converted, trees):
    model = tlpips.load_lpips(converted["lpips"][1])
    rng = np.random.default_rng(3)
    a = rng.uniform(0, 1, (2, 40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    want = np.asarray(jlpips.lpips_distance(trees["lpips"], jnp.asarray(a),
                                            jnp.asarray(b)))
    got = tlpips.lpips_distance(model, torch.as_tensor(a),
                                torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=LPIPS_RTOL)
    assert np.all(want > 0)


@pytest.mark.parametrize("style", WN_STYLES)
def test_volsdf_from_converted_weights_matches_jax(converted, trees, style):
    jcfg, tcfg = jconfig.dtu_config(), tconfig.dtu_config()
    template = init_volsdf_params(torch.Generator().manual_seed(5),
                                  tcfg.model)
    params = load_volsdf_checkpoint(converted[f"volsdf_{style}"][1],
                                    template)
    x = np.random.default_rng(2).uniform(-1.2, 1.2, (512, 3)).astype(
        np.float32)
    want = np.asarray(jnetwork.sdf_values(trees["volsdf"]["sdf"], jcfg.model,
                                          jnp.asarray(x), 3.0))
    with torch.no_grad():
        got = sdf_values(params.sdf, tcfg.model, torch.as_tensor(x),
                         3.0).numpy()
    np.testing.assert_allclose(got, want, atol=SDF_TOL)


def test_pickled_objects_are_refused(tmp_path, trees):
    src = str(tmp_path / "objects.ckpt")
    ck = reference_checkpoint("lpips", trees["lpips"])
    ck["args"] = argparse.Namespace(lr=1e-3)
    torch.save(ck, src)
    with pytest.raises(pickle.UnpicklingError, match="[Ww]eights only"):
        tconvert.main(["--model", "lpips", "--ckpt", src,
                       "--out", str(tmp_path / "out")])
    assert not os.path.exists(tmp_path / "out")
