"""The production-schedule tools of the port (s_volsdf_tpu_torch/tools/
run_100k.py, summarize_100k.py, run_flagship.py) on a tiny scene: the
same functions the command lines run, with a 32x64 fixture, the CPU
tests' narrow widths (tests/test_torch_config.shrink) and one step a
chunk, so a checkpoint every 40 steps:

- a first process is killed after step KILL (exit code 17, no kill-site
  checkpoint); the resume (in this process) restarts from step 40 and
  replays the steps after it, whose rows equal the killed run's in every
  field but the clock's (chunk_s, wall, phase, and the card a process's
  first row names);
- the rows and the last record have the keys of tools/run_100k.py's (read
  from its source), the last record also "card"; its radial errors are
  the JAX package's `sphere_radial_error` of the feedback depths;
- `summarize_100k` writes its run log from that JSONL, naming the card;
- `run_flagship` on the run writes the keys of tools/run_flagship.py's
  JSON.
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from s_volsdf_tpu.data.synthetic import sphere_radial_error
from s_volsdf_tpu_torch.engine.trainer import VolTrainer
from s_volsdf_tpu_torch.tools import run_100k, run_flagship, summarize_100k

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES = (32, 64)
KILL, TARGET = 42, 44
CLOCK_KEYS = {"chunk_s", "wall", "phase", "card"}
# tests/test_torch_config.shrink as overrides, with stage 0's hypotheses
# cut to 16.
OVERRIDES = [
    "model.implicit.dims=[32,32,32,32]", "model.implicit.skip_in=[2]",
    "model.implicit.multires=4", "model.rendering.dims=[32,32]",
    "model.feature_vector_size=32", "model.sampler.N_samples_eval=24",
    "model.sampler.N_samples=16", "model.sampler.N_samples_extra=4",
    "train.num_pixels=16", "train.train_compute_dtype=float32",
    "train.train_activation_dtype=float32", "train.mvs_pack_dtype=float32",
    "train.feedback_render_dtype=float32", "mvs.numdepth=16",
    "mvs.ndepths=[16,8,8]", "mvs.x2_mvsres=false"]


@pytest.fixture(autouse=True, scope="module")
def _small_cpu_runs():
    """One torch thread; subnormals flushed (the feedback renders'
    softplus makes them, and the CPU's log1p takes them slowly); the
    feedback renders in chunks of the image's 2,048 pixels (their
    default 16,384 pads a chunk to its size, eight times this image)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    torch.set_flush_denormal(True)
    render_mvs = VolTrainer.render_mvs
    mp = pytest.MonkeyPatch()
    mp.setattr(VolTrainer, "render_mvs",
               lambda self, v, res_scale=1.0, chunk=RES[0] * RES[1]:
               render_mvs(self, v, res_scale, chunk))
    yield
    mp.undo()
    torch.set_flush_denormal(False)
    torch.set_num_threads(n)


def _dict_keys(path, name, first_key):
    """The string keys of the dict literal assigned to `name` in the
    source at `path` whose first key is `first_key` (a `**{...} if ...`
    entry's keys included)."""
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == name
                        for t in node.targets)):
            keys = node.value.keys
            if getattr(keys[0], "value", None) != first_key:
                continue
            out = []
            for k, v in zip(keys, node.value.values):
                if k is None:
                    out += [x.value for n in ast.walk(v)
                            if isinstance(n, ast.Dict) for x in n.keys]
                else:
                    out.append(k.value)
            return out
    raise LookupError(f"{name} = {{{first_key!r}: ...}} in {path}")


@pytest.fixture(scope="module")
def killed_and_resumed(tmp_path_factory):
    exps = str(tmp_path_factory.mktemp("run100k"))
    args = ["--exps", exps, "--chunk", "1", "--target", str(TARGET)]
    code = ("import sys, torch; torch.set_num_threads(1); "
            "torch.set_flush_denormal(True)\n"
            "from s_volsdf_tpu_torch.tools import run_100k\n"
            f"run_100k.main(sys.argv[1:], img_res={RES!r}, "
            f"overrides={OVERRIDES!r}, device='cpu')\n")
    kill = subprocess.run(
        [sys.executable, "-c", code, *args, "--crash-at", str(KILL)],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    res = run_100k.main(args + ["--resume"], img_res=RES,
                        overrides=OVERRIDES, device="cpu")
    rows = [json.loads(line) for line in
            open(os.path.join(exps, "run100k.jsonl"))]
    return exps, kill, res, rows


def test_kill_and_resume_replays_the_rows(killed_and_resumed):
    _, kill, res, rows = killed_and_resumed
    assert kill.returncode == 17, kill.stderr[-3000:]
    assert f"simulating hard kill at step {KILL}" in kill.stdout
    initial = {r["step"]: r for r in rows[:-1] if r["phase"] == "initial"}
    resumed = {r["step"]: r for r in rows[:-1] if r["phase"] == "resume"}
    assert sorted(initial) == list(range(1, KILL + 1))
    assert sorted(resumed) == list(range(41, TARGET + 1))
    for step in range(41, KILL + 1):
        a = {k: v for k, v in initial[step].items() if k not in CLOCK_KEYS}
        b = {k: v for k, v in resumed[step].items() if k not in CLOCK_KEYS}
        assert a == b, step
    assert initial[1]["card"] == resumed[41]["card"] == "cpu"
    assert rows[-1] == json.loads(json.dumps(res["done"]))
    assert res["done"]["steps"] == TARGET
    assert res["done"]["guard_trips"] == 0


def test_rows_have_the_jax_keys(killed_and_resumed):
    _, _, res, rows = killed_and_resumed
    jax_tool = os.path.join(REPO, "tools", "run_100k.py")
    row_keys = [k for k in _dict_keys(jax_tool, "rec", "step")
                if k != "rescue_mean"]
    done_keys = _dict_keys(jax_tool, "rec", "done")
    phases = set()
    for r in rows[:-1]:
        first = r["phase"] not in phases   # a process's first row
        phases.add(r["phase"])
        assert list(r) == row_keys + (["card"] if first else []), r
    assert list(rows[-1]) == done_keys + ["card"]


def test_radial_error_is_the_jax_function_of_the_depths(killed_and_resumed):
    exps, _, res, _ = killed_and_resumed
    from s_volsdf_tpu_torch.data.scene_dataset import load_scene
    scene = load_scene("DTU", RES, 106, 3, os.path.join(exps, "data"))
    done = res["done"]
    assert list(res["depths"]) == [25, 22, 28]
    for v, depth in res["depths"].items():
        mean_e, med_e, n = sphere_radial_error(
            scene.poses[v], scene.intrinsics[v], scene.img_res, depth,
            scene.scale_factor)
        assert done["radial_error"][v] == {
            "mean_mm": round(mean_e, 3), "median_mm": round(med_e, 3),
            "n_px": n}
    first = res["depths"][25]
    assert done["depth_range"] == [float(first.min()), float(first.max())]


def test_summarize_writes_the_run_log(killed_and_resumed, tmp_path):
    exps = killed_and_resumed[0]
    out = str(tmp_path / "RUNLOG.md")
    summarize_100k.main(os.path.join(exps, "run100k.jsonl"), out)
    text = open(out).read()
    assert "by the PyTorch port on one cpu" in text
    assert f"at step {KILL}" in text and "| *resume phase* |" in text
    assert "2/2 reproduce the original loss" in text


def test_flagship_writes_the_jax_keys(killed_and_resumed, tmp_path):
    exps = killed_and_resumed[0]
    out_path = str(tmp_path / "flagship.json")
    out = run_flagship.main(["--exps", exps, "--out", out_path,
                             "--n-eval", "1"], img_res=RES,
                            overrides=OVERRIDES, device="cpu")
    with open(out_path) as f:
        written = json.load(f)
    jax_tool = os.path.join(REPO, "tools", "run_flagship.py")
    assert list(written) == _dict_keys(jax_tool, "out", "step")
    assert list(written["protocol"]) == ["img_res", "world_scale", "fusion",
                                         "chamfer", "nvs"]
    assert written["step"] == TARGET and out["n_fused_points"] > 0
    assert written["nvs"]["n_views"] == 1
    assert np.isfinite(written["nvs"]["psnr_mean"])
    assert os.path.exists(os.path.join(exps, "fused_flagship.ply"))
