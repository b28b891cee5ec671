"""The readings the limits of `limits/<workload>.json` are set from, on
the card at the cell's own size: the numbers the check compares, of the
program (sound, or with a fault of `faults.py` planted), and of the
control, the reference in the program's place at the next lower
precision than the configuration states (fp8 products for bf16
training; TF32 for the float32 render). One process, many seeds.

    python3 -m port_bench.calibrate --workload <name> --seeds 1 2 3 \\
        --what program control half_batch [--seconds S] [--out FILE]

Prints one JSON line a seed and reading; `--out` appends them to FILE.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from port_bench import faults, run


def reading(cell: run.Cell, seed: int, what: str, device,
            seconds: float = 0.0) -> dict:
    """One reading of `what` ("program", "control" or a fault's name)
    on one seed, after a window of `seconds`."""
    t0 = time.perf_counter()
    entry = cell.entry(seed, device)
    planted = faults.FAULTS.get(what)
    with planted() if planted else contextlib.nullcontext():
        entry.setup({})
        entry.window(seconds)
        entry.finish()
    entry.release()
    numbers = entry.readings(control=what == "control")
    return {"workload": cell.name, "seed": seed, "what": what,
            "numbers": numbers, "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--what", nargs="+", default=["program", "control"])
    ap.add_argument("--seconds", type=float, default=0.0,
                    help="each reading's window, as a run's")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = run.Cell(run.load_spec(), args.workload)
    device = torch.device("cuda", 0)
    run.build_program({})
    for what in args.what:
        for seed in args.seeds:
            line = json.dumps(reading(cell, seed, what, device, args.seconds))
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
