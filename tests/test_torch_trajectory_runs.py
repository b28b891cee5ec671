"""The port's side of the full-width trajectory runs under runs_torch/,
without JAX (so it runs on the card's machine too), and tests of the
helpers that compare two runs.

    python tests/test_torch_trajectory_runs.py against-cpu \\
        --steps 300 --init INIT.npz --out X.jsonl [--all every.json]
    python tests/test_torch_trajectory_runs.py own-loop --seed S \\
        --steps 300 --out Y.jsonl [--from-state S.npz]
    python tests/test_torch_trajectory_runs.py own-loop --seeds 16 \\
        --jax-inits DIR --steps 1000 --out W.jsonl
    python tests/test_torch_trajectory_runs.py inits --seeds 16 \\
        --steps 220 [--jax-inits DIR] --out Z.jsonl

`against-cpu`: one stream (`tools.trajectory.stream`) through the port's
step on the CPU and on `--device`, from one init (the port's at
cfg.seed, or an npz keyed by the port's parameter names: the JAX
package's, written by `tests/test_torch_trajectory.py inits`): both
runs' rows every 50 steps and their `summary`, the spread of one
program on two devices. `own-loop`: the trainer's own loop and draws at
cfg.seed = S (`own_loop`), the port's unpaired run, from the port's init
at S or from a saved JAX TrainState (`--from-state`, an npz that
`tests/test_torch_trajectory.py unpaired --save-at N --state-out` wrote;
every leaf carried by name, Adam's moments and count included) on to
`--steps`; with `--jax-inits DIR --seeds N`, its own loop at each
cfg.seed = s < N from the JAX package's init of seed s. `inits`: for each
seed s < N, the port's step from the port's init at seed s and (with
`--jax-inits`) from the JAX package's, on the stream of seed s
(`anneal_runs`). All at the dtu widths on `tools.trajectory`'s 192x256
fixture with the GT prior, at `--precision` (defaults or float32).
"""

import argparse
import json
import math
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from s_volsdf_tpu_torch.tools import trajectory as traj  # noqa: E402


def summary(rows_a: List[Dict], rows_b: List[Dict]) -> Dict:
    """Two runs of one stream compared: each term's difference at step
    1, its worst over the first 10 steps, the first step at which the
    runs part by each precision's `BARS`, and each run's mean PSNR and
    RGB term from step 21 on (past the first steps' climb)."""
    keys = list(traj.TERMS) + ["grad_norm", "beta"]
    return {"summary": True, "steps": len(rows_a),
            "mean_from_step_21": {k: [float(np.mean([r[k] for r in rows[20:]]))
                                      for rows in (rows_a, rows_b)]
                                  for k in ("psnr", "rgb_loss")},
            "step1": {k: traj.diff(k, rows_a[0][k], rows_b[0][k])
                      for k in keys},
            "worst_first_10": {k: max(traj.diff(k, a[k], b[k]) for a, b in
                                      zip(rows_a[:10], rows_b[:10]))
                               for k in keys},
            **{f"parted_at_{p}_bars": traj.parted(rows_a, rows_b,
                                                  traj.BARS[p])
               for p in traj.BARS}}


def every(rows: List[Dict], n: int) -> List[Dict]:
    """The rows whose step is a multiple of n, and the first."""
    return [r for r in rows if r["step"] % n == 0 or r["step"] == 1]


def chunk_row(step: int, psnrs: List[float], last: Dict, beta: float
              ) -> Dict:
    """An unpaired run's row at `step`: the last step's terms (`last`),
    the mean PSNR over the steps since the previous row, beta."""
    return {"step": step, **{k: float(v) for k, v in last.items()},
            "psnr_mean": float(np.mean(psnrs)), "beta": beta}


def own_loop(su, steps: int, chunk: int = 25) -> List[Dict]:
    """The trainer's own loop on `traj.setup`'s trainer
    (`VolTrainer._get_loop`: the pixels and the sampler's noise from the
    trainer's generator, seeded from cfg.seed) from its state to step
    `steps`: a `chunk_row` every 50 steps, with the colour diagnostics of
    `traj.probe_batch`."""
    from s_volsdf_tpu_torch.engine.trainer import _host_losses
    from s_volsdf_tpu_torch.models.density import get_beta
    tr, cfg = su["trainer"], su["cfg"]
    run_chunk = tr._get_loop(True)
    scene = tr.scene_tensors()
    probe = traj.probe_batch(cfg, su["scene_cpu"])
    rows, psnrs = [], []
    while tr.state.iter_step < steps:
        tr.state, los, _ = run_chunk(tr.state, chunk, scene, su["mvs"], tr.gen)
        los = [_host_losses(lo) for lo in los]
        psnrs += [lo.psnr for lo in los]
        if tr.state.iter_step % 50 == 0:
            beta = float(get_beta(tr.state.params.density,
                                  cfg.model.density.beta_min).detach())
            rows.append({**chunk_row(
                tr.state.iter_step, psnrs,
                {k: getattr(los[-1], k) for k in traj.TERMS}, beta),
                **traj.colour_diagnostics(tr.state.params, cfg, probe,
                                          tr.device)})
            print(json.dumps(rows[-1]), flush=True)
            psnrs = []
    return rows


def load_init(path: str, cfg, device):
    """Parameters of `cfg.model` with every leaf from an npz keyed by
    the port's parameter names."""
    from s_volsdf_tpu_torch.models.network import init_volsdf_params
    params = init_volsdf_params(torch.Generator(), cfg.model, device)
    leaves = np.load(path)
    with torch.no_grad():
        for name, p in params.named_parameters():
            p.copy_(torch.as_tensor(leaves[name]))
    return params


def anneal_runs(su, seeds: int, steps: int, jax_inits: Optional[str],
                device, card: str, precision: str) -> List[Dict]:
    """For each seed s < seeds, the port's step from the port's init at
    seed s and (with jax_inits) from the JAX package's, both on the
    stream of seed s: a row a run with its mean PSNR over steps 25-200
    (the anneal), its steps there under 10 dB, and its PSNR every 50
    steps."""
    from s_volsdf_tpu_torch.models.network import init_volsdf_params
    cfg, out = su["cfg"], []
    for seed in range(seeds):
        batches = list(traj.stream(cfg, su["scene_cpu"], steps, seed))
        inits = {"port": lambda: init_volsdf_params(
            torch.Generator().manual_seed(seed), cfg.model, device)}
        if jax_inits:
            inits["jax"] = lambda: load_init(
                os.path.join(jax_inits, f"jax_init_seed{seed}.npz"), cfg,
                device)
        for name, make in inits.items():
            rows = traj.run_port(cfg, *traj.fresh_state(cfg, make()),
                                 su["mvs"], batches, device)
            anneal = [r["psnr"] for r in rows if 25 <= r["step"] <= 200]
            row = {"seed": seed, "init": name, "device": card,
                   "precision": precision, "steps": steps,
                   "psnr_mean_25_200": float(np.mean(anneal)),
                   "steps_under_10db_25_200": sum(p < 10 for p in anneal),
                   "psnr": {r["step"]: r["psnr"] for r in every(rows, 50)}}
            print(json.dumps(row), flush=True)
            out.append(row)
    return out


def against_cpu(root: str, ovs: List[str], steps: int, init: Optional[str],
                device, card: str, precision: str, everything=None
                ) -> List[Dict]:
    """One stream through the port's step on the CPU and on `device` from
    one init (`init`, an npz, or the port's at cfg.seed): both runs' rows
    every 50 steps, then their `summary`; every step's rows of both into
    `everything` (a path) if given."""
    runs = []
    for name, dev in (("cpu", "cpu"), (card, device)):
        su = traj.setup(root, overrides=ovs, device=dev)
        tr, cfg = su["trainer"], su["cfg"]
        if not runs:
            batches = list(traj.stream(cfg, su["scene_cpu"], steps, 0))
        state, tx = (traj.fresh_state(cfg, load_init(init, cfg, tr.device))
                     if init else (tr.state, tr.tx))
        runs.append((name, traj.run_port(cfg, state, tx, su["mvs"], batches,
                                         tr.device)))
    (n_a, a), (n_b, b) = runs
    if everything:
        with open(everything, "w") as f:
            json.dump({n_a: a, n_b: b}, f)
    rows = [{"package": "port", "device": n, "precision": precision, **r}
            for ra, rb in zip(every(a, 50), every(b, 50))
            for n, r in ((n_a, ra), (n_b, rb))]
    rows.append({"devices": [n_a, n_b], "precision": precision,
                 **summary(a, b)})
    return rows


def main(argv: Optional[List[str]] = None) -> List[Dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["against-cpu", "own-loop", "inits",
                                     "plateau-summary"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--precision", default="defaults",
                    choices=["defaults", "float32"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", default=None,
                    help="the fixture's directory (a temporary one if "
                         "not given)")
    ap.add_argument("--init", default=None,
                    help="against-cpu: both runs' parameters from this "
                         "npz (keyed by the port's parameter names)")
    ap.add_argument("--seed", type=int, default=0,
                    help="own-loop: cfg.seed")
    ap.add_argument("--from-state", default=None,
                    help="own-loop: start from this saved JAX TrainState "
                         "(an npz of `test_torch_trajectory.py unpaired "
                         "--save-at N --state-out`), its leaves carried by "
                         "name, on to --steps")
    ap.add_argument("--seeds", type=int, default=16,
                    help="inits, own-loop with --jax-inits: the inits of "
                         "seeds 0 .. N-1")
    ap.add_argument("--jax-inits", default=None,
                    help="inits, own-loop: a directory of the JAX "
                         "package's inits, jax_init_seed<s>.npz (own-loop: "
                         "its loop at cfg.seed = s from each)")
    ap.add_argument("--all", default=None,
                    help="against-cpu: every step's rows of both, as JSON")
    ap.add_argument("--out", required=True,
                    help="JSONL: a row each 50 steps, or a row a run")
    args = ap.parse_args(argv)
    if args.mode == "plateau-summary":
        # the committed rows' plateau study, for PERF.md (SUMMARY_TAG)
        summary_ = plateau_summary()
        with open(args.out, "w") as f:
            f.write(json.dumps(summary_) + "\n")
        print(json.dumps(summary_))
        print("adam at the state", json.dumps(adam_at_state(
            "plateau_jax_seed2_s250.npz")))
        for run in ("defaults", "float32", "defaults_19839b1",
                    "defaults_aswritten"):
            print(run, json.dumps(gradient_ranges(
                f"grads_plateau_s250_{run}_cpu.json")))
        for prec in ("defaults", "float32"):
            print(prec, json.dumps(logit_ranges(
                f"logits_plateau_s250_{prec}_cpu.json")))
        return [summary_]
    from s_volsdf_tpu_torch.utils.device import card_name, resolve_device
    dev = resolve_device(args.device, "trajectory")
    card = card_name(dev)
    t0 = time.time()
    ovs = traj.precision_overrides(args.precision)
    with tempfile.TemporaryDirectory() as tmp:
        root = args.root or tmp
        if args.mode == "against-cpu":
            rows = against_cpu(root, ovs, args.steps, args.init, dev, card,
                               args.precision, args.all)
        elif args.mode == "own-loop":
            rows = []
            for seed in (range(args.seeds) if args.jax_inits
                         else [args.seed]):
                su = traj.setup(root, overrides=ovs + [f"seed={seed}"],
                                device=dev)
                state = su["trainer"].state
                tag = {"package": "port", "device": card, "seed": seed,
                       "precision": args.precision}
                if args.jax_inits:
                    init = load_init(os.path.join(
                        args.jax_inits, f"jax_init_seed{seed}.npz"),
                        su["cfg"], dev)
                    with torch.no_grad():
                        for p, q in zip(state.params.parameters(),
                                        init.parameters()):
                            p.copy_(q)
                    tag["init"] = "jax"
                if args.from_state:
                    from s_volsdf_tpu_torch.utils.checkpoint import \
                        read_named_state
                    read_named_state(args.from_state, state)
                    tag["from_state"] = os.path.basename(args.from_state)
                rows += [{**tag, **r} for r in own_loop(su, args.steps)]
        else:
            su = traj.setup(root, overrides=ovs, device=dev)
            rows = anneal_runs(su, args.seeds, args.steps, args.jax_inits,
                               dev, card, args.precision)
    with open(args.out, "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print(f"{args.mode}: {time.time() - t0:.1f} s on {card}")
    return rows


# --------------------------------------------------------------------------
# The post-anneal colour plateau: the committed runs' counts
# --------------------------------------------------------------------------

RUNS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "runs_torch")
PLATEAU_MARKS = (300, 600, 1000)
ANNEAL = 200   # loss.anneal_rgb of the dtu preset


def read_jsonl(name: str) -> List[Dict]:
    with open(os.path.join(RUNS, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def run_verdict(rows: List[Dict]) -> Dict:
    """A run's rows read against the plateau: on it (`traj.on_plateau`)
    at each of PLATEAU_MARKS the run reaches, and its escape step
    (`traj.escape_step`)."""
    at = {r["step"]: r for r in rows}
    return {"plateau": {str(m): traj.on_plateau(at[m])
                        for m in PLATEAU_MARKS if m in at},
            "escape": traj.escape_step(rows, ANNEAL)}


def by_seed(rows: List[Dict]) -> Dict[int, List[Dict]]:
    out = {}
    for r in rows:
        out.setdefault(r["seed"], []).append(r)
    return out


def plateau_summary() -> Dict:
    """Runs (a)-(d) of the plateau study from their committed rows:
    each package's `run_verdict` in the paired runs from the saved state
    (a), JAX's own loop on from it (b), the port's own loop from it on
    the card and the CPU (c); and over inits (d), how many runs of each
    package are on the plateau at each mark, with each run's escape
    step. The rows of the port at 19839b1, before its softplus
    derivative was repaired, are read beside (a) at the defaults and
    (d)."""
    out = {}
    for run in ("defaults", "float32", "defaults_19839b1"):
        rows = read_jsonl(f"traj_plateau_paired_{run}_cpu.jsonl")
        out[f"a_{run}"] = {pkg: run_verdict([r for r in rows
                                             if r.get("package") == pkg])
                           for pkg in ("jax", "port")}
    out["b_jax_cpu"] = run_verdict(read_jsonl(
        "traj_unpaired_jax_seed2_s1000_cpu.jsonl"))
    for dev in ("h100", "cpu"):
        out[f"c_port_{dev}"] = run_verdict(read_jsonl(
            f"traj_plateau_port_own_{dev}.jsonl"))
    runs = {name: by_seed(read_jsonl(f"traj_own_jax_inits_s1000{tag}.jsonl"))
            for name, tag in (("port_h100", "_h100"),
                              ("port_h100_19839b1", "_19839b1_h100"))}
    jax_runs = {2: [r for r in read_jsonl(
        "traj_unpaired_jax_seed2_s1000_cpu.jsonl") if r["step"] <= 600]}
    for name in sorted(os.listdir(RUNS)):
        if name.startswith("traj_unpaired_jax_seed") and name.endswith(
                "_s600_cpu.jsonl"):
            rows = read_jsonl(name)
            jax_runs[rows[0]["seed"]] = rows
    runs["jax_cpu"] = jax_runs
    for name, rs in runs.items():
        verdicts = {s: run_verdict(rs[s]) for s in sorted(rs)}
        out[f"d_{name}"] = {
            "runs": len(verdicts),
            "on_plateau": {str(m): sum(v["plateau"].get(str(m), False)
                                       for v in verdicts.values())
                           for m in PLATEAU_MARKS
                           if all(str(m) in v["plateau"]
                                  for v in verdicts.values())},
            "escape": {str(s): v["escape"] for s, v in verdicts.items()}}
    return out


def gradient_ranges(name: str) -> Dict:
    """A `test_torch_trajectory.py gradients` file read over its draws:
    for the saved state and the init, each term's [min, max] of its
    value's difference and of its radiance ("rgb"), SDF and whole
    gradient's."""
    with open(os.path.join(RUNS, name)) as f:
        draws = json.load(f)["draws"]
    out = {}
    for at in ("state", "init"):
        terms = {}
        for k in draws[0][at]:
            vals = {"value": [d[at][k]["value"] for d in draws]}
            for g in ("rgb", "sdf", "whole"):
                vals[g] = [d[at][k]["groups"][g] for d in draws]
            terms[k] = {g: [min(v), max(v)] for g, v in vals.items()}
        out[at] = terms
    return out


def logit_ranges(name: str) -> Dict:
    """A `test_torch_trajectory.py logits` file read over its draws: for
    the saved state and the init, each field's [min, max]."""
    with open(os.path.join(RUNS, name)) as f:
        draws = json.load(f)["draws"]
    return {at: {k: [min(d[at][k] for d in draws),
                     max(d[at][k] for d in draws)] for k in draws[0][at]}
            for at in ("state", "init")}


def adam_at_state(name: str, eps: float = 1e-8) -> Dict:
    """Adam's state in a saved JAX TrainState (`unpaired --state-out`):
    for the radiance MLP's last layer ("rgb_head"), its hidden layers
    ("rgb_hidden") and the SDF MLP ("sdf"), the medians over their
    entries of sqrt(v_hat) (the second moment, bias-corrected at the
    state's count) and of |m_hat| / (sqrt(v_hat) + eps), the step's size
    in units of the learning rate, and the share of entries whose
    sqrt(v_hat) is under eps, where eps, not the gradient's history,
    sets the step."""
    with np.load(os.path.join(RUNS, name)) as data:
        leaves = {str(n): data[f"leaf_{i}"]
                  for i, n in enumerate(data["names"])}
    count = int(next(v for k, v in leaves.items() if k.endswith("count")))
    n_rgb = 1 + max(int(k.split("/")[2]) for k in leaves
                    if k.startswith("params/rgb/"))
    groups: Dict[str, List] = {}
    for k, m in leaves.items():
        if "/mu/" not in k:
            continue
        leaf = k.split("/mu/")[1]
        v = leaves[k.replace("/mu/", "/nu/")]
        net, layer = leaf.split("/")[:2]
        if net == "rgb":
            net = "rgb_head" if int(layer) == n_rgb - 1 else "rgb_hidden"
        elif net != "sdf":
            continue
        groups.setdefault(net, []).append(
            (np.abs(m).ravel() / (1 - 0.9 ** count),
             np.sqrt(v.ravel() / (1 - 0.999 ** count))))
    out = {"count": count}
    for net, parts in groups.items():
        m = np.concatenate([a for a, _ in parts])
        r = np.concatenate([b for _, b in parts])
        out[net] = {"sqrt_v_median": float(np.median(r)),
                    "step_median": float(np.median(m / (r + eps))),
                    "share_sqrt_v_under_eps": float(np.mean(r < eps))}
    return out


PERF_MD = os.path.join(os.path.dirname(RUNS), "PERF.md")
SUMMARY_TAG = "Plateau study, as `plateau_summary` reads the rows:"


def perf_md_summary() -> Dict:
    """The plateau study's summary as PERF.md states it: the JSON on the
    line after SUMMARY_TAG."""
    with open(PERF_MD) as f:
        lines = f.read().splitlines()
    return json.loads(lines[lines.index(SUMMARY_TAG) + 1].strip("` "))


def test_plateau_counts_match_perf_md():
    """The committed rows of the plateau study (runs_torch/: the paired
    runs from JAX's trapped state, JAX's own loop on from it, the port's
    own loop from it on the card and the CPU, both packages' runs over
    inits) read as PERF.md states them: each run's plateau marks and
    escape step, and the counts over inits at 300, 600 and 1000 steps.
    Every row holds the colour diagnostics."""
    for name in os.listdir(RUNS):
        if "plateau" in name or "s1000" in name or "s600" in name:
            if name.endswith(".jsonl"):
                for r in read_jsonl(name):
                    if "step" in r and (r["step"] % 50 == 0):
                        assert {"relu_zero", "sigmoid_saturated",
                                "rgb_mean"} <= set(r), (name, r["step"])
    assert plateau_summary() == perf_md_summary()


def test_plateau_reading():
    """`traj.on_plateau` reads the JAX package's seed-2 rows at steps 250
    and 300 (22.96 / 22.95 dB, RGB L1 0.0645 / 0.0648) as on the
    plateau and its rows inside the anneal as not; `traj.escape_step`
    takes the first row past the anneal under 0.05."""
    rows = read_jsonl("traj_unpaired_jax_seed2_cpu.jsonl")
    assert [traj.on_plateau(r) for r in rows] == [False] * 4 + [True] * 2
    assert traj.escape_step(rows, ANNEAL) is None
    moved = [dict(r) for r in rows] + [{"step": 350, "rgb_loss": 0.049,
                                        "psnr": 26.0}]
    moved[3]["rgb_loss"] = 0.01   # inside the anneal: not an escape
    assert traj.escape_step(moved, ANNEAL) == 350


# --------------------------------------------------------------------------
# Tests of the comparison helpers (no training)
# --------------------------------------------------------------------------

def _rows(n, **scale):
    """n synthetic rows of every term, each term's value scaled by
    `scale` from step `scale['from_step']` on."""
    out = []
    for step in range(1, n + 1):
        row = {"step": step, "beta": 0.1, "grad_norm": 1.0 + step,
               "grad_finite": 1.0}
        for k in traj.TERMS:
            v = 20.0 + step if k == "psnr" else 0.1 / step
            if step >= scale.get("from_step", n + 1):
                v = v + scale["psnr_db"] if k == "psnr" else v * scale["rel"]
            row[k] = v
        out.append(row)
    return out


def test_diff_relative_and_in_db():
    """`diff`: relative to the larger magnitude, the PSNR in dB, 0 for
    two zeros (the sparse term after the anneal, the RGB term with no
    gated ray)."""
    assert traj.diff("loss", 0.1, 0.11) == abs(0.1 - 0.11) / 0.11
    assert traj.diff("loss", -0.2, 0.2) == 2.0
    assert traj.diff("sparse_loss", 0.0, 0.0) == 0.0
    assert traj.diff("psnr", 20.0, 20.5) == 0.5


@pytest.mark.parametrize("precision", sorted(traj.BARS))
def test_parted_at_the_first_step_past_each_bar(precision):
    """`parted`: None for every term of two equal runs; with every term
    moved by twice its bar from step 7 on, 7 for each."""
    bars = traj.BARS[precision]
    base = _rows(12)
    assert traj.parted(base, _rows(12), bars) == dict.fromkeys(bars)
    for k, bar in bars.items():
        moved = _rows(12, from_step=7, rel=1 + 2 * bar, psnr_db=2 * bar)
        assert traj.parted(base, moved, {k: bar}) == {k: 7}
        assert traj.parted(base, moved[:6], {k: bar}) == {k: None}


def test_summary_and_every():
    """`summary` reads step 1's difference, the worst of the first 10
    steps and each precision's parting step; `every` keeps step 1 and
    the multiples of n."""
    a, b = _rows(30), _rows(30, from_step=5, rel=1.5, psnr_db=1.0)
    s = summary(a, b)
    assert s["steps"] == 30 and s["step1"]["loss"] == 0.0
    assert math.isclose(s["worst_first_10"]["loss"], 0.5 / 1.5)
    assert s["worst_first_10"]["psnr"] == 1.0
    assert s["parted_at_defaults_bars"]["loss"] == 5
    assert s["parted_at_float32_bars"]["psnr"] == 5
    assert s["mean_from_step_21"]["psnr"][1] - s["mean_from_step_21"][
        "psnr"][0] == 1.0
    assert [r["step"] for r in every(a, 10)] == [1, 10, 20, 30]


if __name__ == "__main__":
    main()
