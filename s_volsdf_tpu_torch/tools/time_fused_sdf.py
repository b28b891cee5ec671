"""Times the fused SDF kernel of this checkout on one GPU, against
another copy of the port in one run, and profiles one block.

    python3 -m s_volsdf_tpu_torch.tools.time_fused_sdf [--other DIR] [--trace]

`--other DIR`: DIR holds another `s_volsdf_tpu_torch` package, for
example the parent commit's (`git archive HEAD s_volsdf_tpu_torch | tar
-x -C DIR`). The two trees are timed in turns, other, this, this, other,
each in its own process with its tree first on `sys.path`, building its
own kernel into its own `_build/`. Each turn times by CUDA events (median
of 20 launches after 3 warm-ups) the dtu SDF MLP (random weights from
seed 0, points from a unit normal, bounding sphere 3) at 65,536 points
(one training sweep) and 2,097,152 points (one render launch): the
kernel alone (weights packed beforehand: `pack_sdf`, or `_pack_params`
in a tree that predates it) and the wrapper called without a pack; and
the plain version at 65,536 points, with the kernel's max |diff| to it.

A tree whose kernel has the bfloat16 mode is timed in both modes (the
dtu model with compute_dtype and activation_dtype "bfloat16"), the
bfloat16 mode's error against its own plain version.

`--trace`: builds this checkout's kernel with -DFUSED_SDF_TRACE=100 (a
separate library, `_build/libfused_sdf_trace.so`) and prints, for block
100 of a 2,097,152-point launch in each mode, each consumer warpgroup's
cycles per layer in its products (wgmma, waiting on the weight ring
included) and in its epilogue (softplus, split or rounding, stores; the
skip junction's encoding; the SDF dot product), from `clock64()`
stamps.

Prints the card's name and power limit first, one JSON line per turn,
then a summary.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

POINTS = (65536, 2097152)
FLOP_PER_POINT = 2 * 459264      # the dtu width, SDF column only
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def _median_ms(fn, reps: int = 20) -> float:
    import numpy as np
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _setup(device, mode: str = "float32"):
    import numpy as np
    import torch
    from s_volsdf_tpu_torch.config import dtu_config
    from s_volsdf_tpu_torch.models.network import init_volsdf_params
    cfg = dtu_config()
    cfg.model.compute_dtype = cfg.model.activation_dtype = mode
    params = init_volsdf_params(torch.Generator().manual_seed(0), cfg.model,
                                device)
    pts = {n: torch.as_tensor(np.random.default_rng(1).normal(size=(n, 3))
                              .astype(np.float32), device=device)
           for n in POINTS}
    return cfg, params, pts


def _time_mode(fs, dev, mode: str) -> dict:
    """One mode's kernel and wrapper times and its error to its plain
    version, in the package `fs`."""
    import torch
    cfg, params, pts = _setup(dev, mode)
    stream = torch.cuda.current_stream(dev).cuda_stream
    kernel_ms, wrapper_ms = {}, {}
    for n, p in pts.items():
        if hasattr(fs, "pack_sdf"):
            pack = fs.pack_sdf(params.sdf, cfg.model)

            def kernel(p=p, pack=pack):
                return fs.fused_sdf_values(params.sdf, cfg.model, p, 3.0,
                                           pack=pack)
        else:   # the wrapper that packed on every launch
            packed, meta = fs._pack_params(params.sdf, cfg.model, 3.0, dev)
            lib = fs._load()
            out = torch.empty((n,), device=dev)

            def kernel(p=p, n=n, packed=packed, meta=meta, lib=lib, out=out):
                lib.fused_sdf_forward(p.data_ptr(), packed.data_ptr(),
                                      out.data_ptr(), n, meta, stream)
        kernel_ms[n] = _median_ms(kernel)
        wrapper_ms[n] = _median_ms(
            lambda p=p: fs.fused_sdf_values(params.sdf, cfg.model, p, 3.0))
    n = POINTS[0]
    got = fs.fused_sdf_values(params.sdf, cfg.model, pts[n], 3.0)
    ref = fs.sdf_values_plain(params.sdf, cfg.model, pts[n], 3.0)
    return {"kernel_ms": kernel_ms, "wrapper_ms": wrapper_ms,
            "plain_ms": _median_ms(lambda: fs.sdf_values_plain(
                params.sdf, cfg.model, pts[n], 3.0)),
            "max_abs_err": (got - ref).abs().max().item()}


def child(tree: str) -> None:
    """One turn: times the kernel of the package under `tree`, in each
    mode it has."""
    sys.path.insert(0, tree)
    import torch
    from s_volsdf_tpu_torch.ops import fused_sdf as fs
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    fs.build(force=True)
    modes = getattr(fs, "MODES", ("float32",))
    print(json.dumps({"tree": tree, **{m: _time_mode(fs, dev, m)
                                       for m in modes}}))


def trace(mode: str, block: int = 100) -> None:
    """Per-layer cycles of one block in `mode`, from the kernel's
    FUSED_SDF_TRACE stamps (see csrc/fused_sdf.cu)."""
    import torch
    sys.path.insert(0, REPO)
    from s_volsdf_tpu_torch.ops import fused_sdf as fs
    from s_volsdf_tpu_torch.ops.build import NVCC_FLAGS, build_library, nvcc
    so = build_library([nvcc()] + NVCC_FLAGS + [f"-DFUSED_SDF_TRACE={block}"],
                       fs.SOURCE, "libfused_sdf_trace.so", force=True)
    lib = fs.bind(so)
    lib.fused_sdf_trace.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    cfg, params, pts = _setup(dev, mode)
    pack = fs.pack_sdf(params.sdf, cfg.model)
    saved, fs._LIB = fs._LIB, lib
    try:
        for _ in range(3):
            fs.fused_sdf_values(params.sdf, cfg.model, pts[POINTS[1]], 3.0,
                                pack=pack)
        torch.cuda.synchronize()
    finally:
        fs._LIB = saved
    n = pack.meta.n_hidden
    width = 2 * fs.MAX_LAYERS + 1
    buf = (ctypes.c_longlong * (2 * width))()
    if lib.fused_sdf_trace(buf) != 0:
        raise RuntimeError("reading the trace failed")
    for wg in range(2):
        t = buf[wg * width:(wg + 1) * width]
        mma = [t[1 + 2 * l] - t[2 * l] for l in range(n)]
        epi = [t[2 + 2 * l] - t[1 + 2 * l] for l in range(n)]
        total = t[2 * n] - t[0]
        print(f"[trace] {mode}, block {block}, warpgroup {wg}: {total} "
              f"cycles; "
              f"products {sum(mma)} ({100 * sum(mma) / total:.1f}%), "
              f"epilogues {sum(epi)} ({100 * sum(epi) / total:.1f}%); "
              f"per layer products {mma}, epilogues {epi}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="directory holding another "
                    "s_volsdf_tpu_torch package, timed in turns with this one")
    ap.add_argument("--trace", action="store_true",
                    help="profile one block of this checkout's kernel")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_fused_sdf: no CUDA device; this script runs on a GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    trees = [REPO]
    if args.other:
        other = os.path.abspath(args.other)
        trees = [other, REPO, REPO, other]
    runs = []
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", tree], capture_output=True,
                             text=True)
        if res.returncode != 0:
            raise RuntimeError(f"turn {tree} failed:\n{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for tree in dict.fromkeys(trees):
        mine = [r for r in runs if r["tree"] == tree]
        for mode in [m for m in mine[0] if m != "tree"]:
            for n in POINTS:
                ms = [r[mode]["kernel_ms"][str(n)] for r in mine]
                wr = [r[mode]["wrapper_ms"][str(n)] for r in mine]
                print(f"[time] {tree}: {mode} mode, {n} points, kernel "
                      + " / ".join(f"{m:.4f}" for m in ms) + " ms ("
                      + " / ".join(f"{n * FLOP_PER_POINT / m / 1e9:.1f}"
                                   for m in ms)
                      + " TFLOP/s), wrapper "
                      + " / ".join(f"{m:.4f}" for m in wr)
                      + f" ms [{card}]", flush=True)
    if args.trace:
        sys.path.insert(0, REPO)
        from s_volsdf_tpu_torch.ops.fused_sdf import MODES
        for mode in MODES:
            trace(mode)


if __name__ == "__main__":
    main()
