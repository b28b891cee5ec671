"""Times the deformable-conv kernel of this checkout on one GPU against
other copies of the port, in one run.

    python3 -m s_volsdf_tpu_torch.tools.time_deform_conv [--other DIR]...
        [--pairs N] [--ablate]

`--other DIR` (repeatable): DIR holds another `s_volsdf_tpu_torch`
package, for example the parent commit's (`git archive HEAD
s_volsdf_tpu_torch | tar -x -C DIR`). The trees are timed in turns
(others, this, this, others; `--pairs` times), each in its own process
with its tree first on `sys.path`, building its own kernel into its own
`_build/`. A turn times by CUDA events (median of 20 launches after 3
warm-ups, each behind a queued device sleep so that the wrapper's host
time is hidden) TransMVSNet's DCN shapes at x2 DTU (Cin 32; 32 -> 32 at
288x384, 576x768 and 1152x1536; 32 -> 16 at 576x768; 32 -> 8 at
1152x1536) on chip_smoke.py's inputs (offsets with a 2-pixel spread,
masks in (0, 1)), and the 1152x1536 32 -> 32 launch again with zero
offsets (every sample on a pixel of the image, none outside its
tile's window), with the max |diff| to the plain version there. The
trees' kernels are called through `deform_conv2d`, the single-image
entry point every tree has.

`--ablate`: also times this checkout's kernel at the 1152x1536 32 -> 32
shape, in this process, built with -DDEFORM_CONV_ABLATE=1 (no window
filled after the first tile's), =2 (no sampling: constant samples, no
offset or mask read), =4 (no contraction: the samples summed on the
FP32 pipe) and =7 (none of the three: what is left is the tile loop and
the output), beside the full build: what each phase adds to the time
where the others do not hide it. Prints the share of chip_smoke's
samples outside their tile's window too.

Prints the card's name and power limit first, one JSON line per turn,
then each tree's median over its turns.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

SHAPES = ((288, 384, 32), (576, 768, 32), (576, 768, 16), (1152, 1536, 32),
          (1152, 1536, 8))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _turn() -> dict:
    """One tree's timings, in this process (the tree is on sys.path)."""
    import numpy as np
    import torch
    from s_volsdf_tpu_torch.ops import deform_conv as D

    def inputs(H, W, cout, zero=False):
        gen = torch.Generator().manual_seed(H + cout)
        K, cin = D.TAPS, 32
        x = torch.randn((cin, H, W), generator=gen)
        offset = 2.0 * torch.randn((2 * K, H, W), generator=gen)
        if zero:
            offset.zero_()
        mask = torch.rand((K, H, W), generator=gen)
        bound = 1.0 / (K * cin) ** 0.5
        w = torch.rand((K * cin, cout), generator=gen) * (2 * bound) - bound
        b = 0.1 * torch.randn((cout,), generator=gen)
        return [t.cuda() for t in (x, offset, mask, w, b)]

    def median_ms(fn, reps=20):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(5_000_000)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    D.build(force=True)
    out = {}
    for H, W, cout in SHAPES:
        args = inputs(H, W, cout)
        out[f"{H}x{W}x{cout}"] = median_ms(lambda: D.deform_conv2d(*args))
    args = inputs(1152, 1536, 32, zero=True)
    out["1152x1536x32 zero offsets"] = median_ms(
        lambda: D.deform_conv2d(*args))
    err = (D.deform_conv2d(*args) - D.deform_conv2d_plain(*args)).abs().max()
    out["max_abs_err"] = err.item()
    return out


def _ablate() -> dict:
    """The 1152x1536 32 -> 32 launch of the full build and of the timing
    builds, and the share of its samples outside the window."""
    import numpy as np
    import torch
    from s_volsdf_tpu_torch.ops import build, deform_conv as D
    gen = torch.Generator().manual_seed(1184)
    K = D.TAPS
    args = [torch.randn((32, 1152, 1536), generator=gen),
            2.0 * torch.randn((2 * K, 1152, 1536), generator=gen),
            torch.rand((K, 1152, 1536), generator=gen),
            torch.rand((K * 32, 32), generator=gen) / 17.0,
            torch.zeros(32)]
    args = [t.cuda() for t in args]
    out = {"outside_window_share": D.outside_window_share(args[1])}
    lib = D._load()
    builds = {0: "full", 1: "no window fill", 2: "no sampling",
              4: "no contraction", 7: "none of the three"}
    for mode, name in builds.items():
        if mode:
            flags = build.NVCC_FLAGS + [f"-DDEFORM_CONV_ABLATE={mode}"]
            path = build.build_library([build.nvcc()] + flags, D.SOURCE,
                                       f"libdeform_conv_ablate{mode}.so",
                                       force=True)
            D._LIB = D.bind(path)
        for _ in range(3):
            D.deform_conv2d(*args)
        torch.cuda.synchronize()
        times = []
        for _ in range(20):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(5_000_000)
            start.record()
            D.deform_conv2d(*args)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        out[name] = float(np.median(times))
        D._LIB = lib
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[])
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--ablate", action="store_true")
    ap.add_argument("--turn", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.turn:
        print(json.dumps(_turn()))
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    trees = [os.path.abspath(d) for d in args.other]
    order = []
    for _ in range(args.pairs):
        order += trees + [REPO, REPO] + trees[::-1]
    results = {t: [] for t in [REPO] + trees}
    for tree in order:
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run(
            [sys.executable, "-m", "s_volsdf_tpu_torch.tools.time_deform_conv",
             "--turn", "1"], cwd=tree, env=env, capture_output=True,
            text=True)
        if res.returncode != 0:
            raise RuntimeError(f"{tree}: {res.stderr[-3000:]}")
        row = json.loads(res.stdout.strip().splitlines()[-1])
        results[tree].append(row)
        print(json.dumps({"tree": tree, **row}), flush=True)
    for tree, rows in results.items():
        med = {k: sorted(r[k] for r in rows)[len(rows) // 2] for k in rows[0]}
        print(json.dumps({"tree": tree, "median": med, "card": card}),
              flush=True)
    if args.ablate:
        print(json.dumps({"tree": REPO, "1152x1536x32 ablated": _ablate(),
                          "card": card}), flush=True)


if __name__ == "__main__":
    main()
