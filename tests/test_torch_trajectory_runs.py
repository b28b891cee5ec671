"""The port's side of the full-width trajectory runs under runs_torch/,
without JAX (so it runs on the card's machine too), and tests of the
helpers that compare two runs.

    python tests/test_torch_trajectory_runs.py against-cpu \\
        --steps 300 --init INIT.npz --out X.jsonl [--all every.json]
    python tests/test_torch_trajectory_runs.py own-loop --seed S \\
        --steps 300 --out Y.jsonl
    python tests/test_torch_trajectory_runs.py inits --seeds 16 \\
        --steps 220 [--jax-inits DIR] --out Z.jsonl

`against-cpu`: one stream (`tools.trajectory.stream`) through the port's
step on the CPU and on `--device`, from one init (the port's at
cfg.seed, or an npz keyed by the port's parameter names: the JAX
package's, written by `tests/test_torch_trajectory.py inits`): both
runs' rows every 50 steps and their `summary`, the spread of one
program on two devices. `own-loop`: the trainer's own loop and draws at
cfg.seed = S (`own_loop`), the port's unpaired run. `inits`: for each
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
    trainer's generator, seeded from cfg.seed): a `chunk_row` every 50
    steps."""
    from s_volsdf_tpu_torch.engine.trainer import _host_losses
    from s_volsdf_tpu_torch.models.density import get_beta
    tr, cfg = su["trainer"], su["cfg"]
    run_chunk = tr._get_loop(True)
    scene = tr.scene_tensors()
    rows, psnrs = [], []
    while tr.state.iter_step < steps:
        tr.state, los, _ = run_chunk(tr.state, chunk, scene, su["mvs"], tr.gen)
        los = [_host_losses(lo) for lo in los]
        psnrs += [lo.psnr for lo in los]
        if tr.state.iter_step % 50 == 0:
            beta = float(get_beta(tr.state.params.density,
                                  cfg.model.density.beta_min).detach())
            rows.append(chunk_row(tr.state.iter_step, psnrs,
                                  {k: getattr(los[-1], k) for k in traj.TERMS},
                                  beta))
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
    ap.add_argument("mode", choices=["against-cpu", "own-loop", "inits"])
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
    ap.add_argument("--seeds", type=int, default=16,
                    help="inits: the inits of seeds 0 .. N-1")
    ap.add_argument("--jax-inits", default=None,
                    help="inits: a directory of the JAX package's inits, "
                         "jax_init_seed<s>.npz")
    ap.add_argument("--all", default=None,
                    help="against-cpu: every step's rows of both, as JSON")
    ap.add_argument("--out", required=True,
                    help="JSONL: a row each 50 steps, or a row a run")
    args = ap.parse_args(argv)
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
            su = traj.setup(root, overrides=ovs + [f"seed={args.seed}"],
                            device=dev)
            rows = [{"package": "port", "device": card, "seed": args.seed,
                     "precision": args.precision, **r}
                    for r in own_loop(su, args.steps)]
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
