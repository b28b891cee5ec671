"""Times the cost-mapping kernel of this checkout on one GPU, warm and
cold, against another checkout's in one run, and traces one launch.

    python3 -m s_volsdf_tpu_torch.tools.time_cost_mapping [--other DIR]
        [--pairs N] [--trace] [--ptxas] [--scaling]

`--other DIR`: DIR is another whole checkout of the repository (for the
parent commit: `git archive HEAD | tar -x -C DIR`). The two trees are
timed in turns, other, this, this, other (N pairs), each in its own
process with its tree first on `sys.path`, building its own kernel into
its own `_build/`. A turn sets up bench.py's shapes with the tree's own
`chip_smoke.make_volumes` (a 576x768 three-view sphere scene, three
192x288x384 volumes, seed 7) and, for bf16 and float32 volumes:

  * the kernel's copy of the volumes (`check_volumes`, in a tree that
    has it): its host-clock milliseconds;
  * cold: the kernel on 20 different sample sets (512 rays x 96
    samples each, `samples` with seeds 100-119, views 0, 1, 2 in turn),
    each launch behind a queued device sleep and a write of a 256 MB
    scratch buffer (outside the timing events), so that the volumes'
    sectors are not in the 50 MB L2, as a training step finds them
    behind the MLP's activations; median of the 20 and the median of the
    sets' bounds at 3.35 TB/s: the bytes of the layout the tree's
    kernel reads (`packed_bytes` for corner-block copies, else
    `touched_bytes`; the smaller of the two) and, beside it, of the
    volumes as the caller holds them (`touched_bytes`);
  * warm: one sample set 20 times in a row, behind the sleep (the
    sectors stay in L2), the way earlier smoke runs timed it;
  * wrapper: the call as the step makes it, with no sleep, so that the
    host's time shows (median of 20 by events), and the host's time per
    call over 2,000 calls in a row.

`--trace` builds this checkout's kernel with -DCOST_MAPPING_TRACE
(`_build/libcost_mapping_trace.so`) and prints, for one cold launch of
bf16 volumes, the span of the grid's block starts and ends (%globaltimer)
and the median cycles of a block's first warp in its three round trips
(point and cameras; slab and the volume's index; volume and the
reduction). It also times an empty kernel the same way as the cold
launches: the timing's own floor. `--ptxas` prints
what `nvcc -Xptxas -v` says of each instantiation (registers, spills,
shared memory). `--scaling` prints what bounds the kernel: its cold
and warm times at 64 to 2,048 rays, the timing's floor with and without
the scratch write, and its SASS instruction counts.

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

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RAYS, SAMPLES = 512, 96            # one training step's samples
VOLUMES = (192, 288, 384)          # bench.py's stage-0 volumes
IMG_RES = (576, 768)
COLD_SETS = 20
SCRATCH_BYTES = 256 * 2 ** 20      # five times the H100's 50 MB L2
BACKLOG_CYCLES = 5_000_000
HBM_TBPS = 3.35


def samples(scene, view: int, device, seed: int):
    """xyz (512, 96, 3) along rays of `view` through pixels a little past
    the image, at sorted depths in [0.3, 5.5]: inside and outside the
    hypothesis slab, in front of and behind some of the cameras."""
    import torch
    rng = np.random.default_rng(seed)
    H, W = scene.img_res
    K, c2w = scene.intrinsics[view], scene.poses[view]
    px = np.stack([rng.uniform(-4, W + 4, RAYS),
                   rng.uniform(-4, H + 4, RAYS)], -1)
    d_cam = np.stack([(px[:, 0] - K[0, 2]) / K[0, 0],
                      (px[:, 1] - K[1, 2]) / K[1, 1], np.ones(RAYS)], -1)
    d = d_cam @ c2w[:3, :3].T
    z = np.sort(rng.uniform(0.3, 5.5, (RAYS, SAMPLES)), axis=1)
    xyz = c2w[:3, 3] + z[..., None] * d[:, None, :]
    return torch.as_tensor(xyz.astype(np.float32), device=device)


def sample_sets(scene, device, n_views: int = 3):
    """COLD_SETS (xyz, onehot) pairs: seeds 100-119, views in turn."""
    import torch
    sets = []
    for k in range(COLD_SETS):
        view = k % n_views
        onehot = torch.zeros(n_views, device=device)
        onehot[view] = 1.0
        sets.append((samples(scene, view, device, 100 + k), onehot))
    return sets


def median_ms(fn, reps: int = 20, backlog: bool = False) -> float:
    """Median of `reps` CUDA-event timings of fn, the same inputs each
    time (warm: what fn reads stays in L2). With `backlog`, each behind a
    queued device sleep, so that fn's device time is measured and not
    its host time."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if backlog:
            torch.cuda._sleep(BACKLOG_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def cold_ms(calls) -> list:
    """CUDA-event times (ms) of each call in `calls`, each behind a queued
    device sleep and a write of SCRATCH_BYTES (both outside the events),
    so that it finds its inputs in device memory, not in L2."""
    import torch
    scratch = torch.empty(SCRATCH_BYTES // 4, device="cuda")
    for fn in calls[:3]:
        fn()
    torch.cuda.synchronize()
    times = []
    for k, fn in enumerate(calls):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(BACKLOG_CYCLES)
        scratch.fill_(float(k))
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def host_us(fn, reps: int = 2000) -> float:
    """Host microseconds per call of fn, over `reps` calls in a row (the
    device keeps up: a call's kernel takes less than its host time)."""
    import time
    import torch
    for _ in range(200):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    us = (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize()
    return us


def time_volumes(cm, mvs, sets) -> dict:
    """Cold, warm and wrapper times of `cm.cost_mapping` on `mvs`, with
    the sets' bounds: the bytes of the layout the tree's kernel reads
    (`packed_bytes` where the tree has corner-block copies, else
    `touched_bytes`) and of the volumes as the caller holds them. A tree
    with `check_volumes` makes the kernel's copy first (timed once)."""
    import time
    import torch
    pack_ms = None
    if hasattr(cm, "check_volumes"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mvs = cm.check_volumes(mvs)
        torch.cuda.synchronize()
        pack_ms = (time.perf_counter() - t0) * 1e3
    calls = [lambda x=x, o=o: cm.cost_mapping(None, x, o, mvs)
             for x, o in sets]
    cold = cold_ms(calls)
    layout = getattr(cm, "packed_bytes", cm.touched_bytes)

    def bound(fn):
        return float(np.median([min(fn(x, mvs), cm.touched_bytes(x, mvs))
                                for x, _ in sets])) / (HBM_TBPS * 1e12) * 1e3

    return {"ms_cold": float(np.median(cold)), "cold_all": cold,
            "ms_warm": median_ms(calls[0], backlog=True),
            "wrapper_ms": median_ms(calls[0]),
            "wrapper_host_us": host_us(calls[0]),
            "bound_ms": bound(layout),
            "bytes_unpacked_ms": bound(cm.touched_bytes),
            "pack_ms": pack_ms}


def child(tree: str) -> None:
    """One turn: the kernel of the checkout at `tree`."""
    sys.path.insert(0, tree)
    import dataclasses
    import torch
    import chip_smoke
    from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
    from s_volsdf_tpu_torch.ops import cost_mapping as cm
    dev = torch.device("cuda")
    cm.build(force=True)
    scene = make_sphere_scene(3, IMG_RES)
    f32 = chip_smoke.make_volumes(scene, VOLUMES, dev)
    sets = sample_sets(scene, dev)
    # The harness's own floor: an empty kernel timed the same way.
    out = {"tree": tree, "floor_ms": float(np.median(cold_ms(
        [lambda: torch.cuda._sleep(0)] * COLD_SETS)))}
    for dtype in (torch.bfloat16, torch.float32):
        mvs = dataclasses.replace(f32, prob=f32.prob.to(dtype))
        out[str(dtype).replace("torch.", "")] = time_volumes(cm, mvs, sets)
    print(json.dumps(out))


def trace() -> None:
    """One cold launch of a -DCOST_MAPPING_TRACE build on bf16 volumes:
    block start/end spread and per-phase cycles."""
    sys.path.insert(0, REPO)
    import dataclasses
    import torch
    import chip_smoke
    from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
    from s_volsdf_tpu_torch.ops import cost_mapping as cm
    from s_volsdf_tpu_torch.ops.build import build_library, nvcc
    so = build_library([nvcc()] + cm.FLAGS + ["-DCOST_MAPPING_TRACE"],
                       cm.SOURCE, "libcost_mapping_trace.so", force=True)
    lib = cm.bind(so)
    dev = torch.device("cuda")
    scene = make_sphere_scene(3, IMG_RES)
    f32 = chip_smoke.make_volumes(scene, VOLUMES, dev)
    mvs = cm.check_volumes(dataclasses.replace(
        f32, prob=f32.prob.to(torch.bfloat16)))
    (xyz, onehot), = sample_sets(scene, dev)[:1]
    cm._load()
    saved, cm._LIB = cm._LIB, lib
    try:
        ms = cold_ms([lambda: cm.cost_mapping(None, xyz, onehot, mvs)] * 4)
    finally:
        cm._LIB = saved
    n = xyz.shape[0] * xyz.shape[1]
    warps = -(-n // 10)                # V = 3: 10 samples a warp
    blocks = -(-warps * 32 // 256)
    buf = (ctypes.c_longlong * (5 * blocks))()
    if lib.cost_mapping_trace(buf, blocks) != 0:
        raise RuntimeError("reading the trace failed")
    t = np.frombuffer(buf, dtype=np.int64).reshape(blocks, 5)
    start, end = t[:, 0] - t[:, 0].min(), t[:, 1] - t[:, 0].min()
    print(f"[trace] bf16 volumes, {blocks} blocks, last launch "
          f"{ms[-1]:.4f} ms (events): blocks start over "
          f"{start.max() / 1e3:.2f} us, end between {end.min() / 1e3:.2f} "
          f"and {end.max() / 1e3:.2f} us after the first start; a block "
          f"lasts {np.median(end - start) / 1e3:.2f} us (median, "
          f"{np.percentile(end - start, 90) / 1e3:.2f} at the 90th "
          f"percentile); its first warp's cycles (median) in the point and "
          f"cameras {int(np.median(t[:, 2]))}, the slab and the volume's "
          f"index {int(np.median(t[:, 3]))}, the volume and the reduction "
          f"{int(np.median(t[:, 4]))}", flush=True)


def scaling() -> None:
    """What bounds this checkout's kernel: its cold and warm times at 64
    to 2,048 rays of 96 samples (bf16 volumes; beyond 512 rays the sets
    are repeated, shifted by 1e-3 per copy), the timing's floor with and
    without the scratch write, and the instructions in its SASS."""
    import collections
    import dataclasses
    import torch
    sys.path.insert(0, REPO)
    import chip_smoke
    from s_volsdf_tpu_torch.data.synthetic import make_sphere_scene
    from s_volsdf_tpu_torch.ops import cost_mapping as cm
    from s_volsdf_tpu_torch.tools.fp64_count import INSTR, cuobjdump
    dev = torch.device("cuda")
    lib = cm.build(force=True)
    cm._load()
    sass = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    fn, counts = None, collections.defaultdict(collections.Counter)
    for line in sass.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            continue
        m = INSTR.search(line)
        if m and fn:
            counts[fn][m.group(1).split(".")[0]] += 1
    for fn, c in counts.items():
        print(f"[scaling] {fn}: {sum(c.values())} SASS instructions; "
              + ", ".join(f"{k} {v}" for k, v in c.most_common(12)),
              flush=True)

    def events_only():
        times = []
        for _ in range(COLD_SETS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(BACKLOG_CYCLES)
            start.record()
            torch.cuda._sleep(0)
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    floor = float(np.median(cold_ms([lambda: torch.cuda._sleep(0)]
                                    * COLD_SETS)))
    print(f"[scaling] an empty kernel: {floor:.4f} ms behind the sleep and "
          f"the scratch write, {events_only():.4f} ms behind the sleep "
          f"alone", flush=True)
    scene = make_sphere_scene(3, IMG_RES)
    f32 = chip_smoke.make_volumes(scene, VOLUMES, dev)
    mvs = cm.check_volumes(dataclasses.replace(
        f32, prob=f32.prob.to(torch.bfloat16)))
    sets = sample_sets(scene, dev)
    for rays in (64, 128, 256, 512, 1024, 2048):
        calls = []
        for x, o in sets:
            copies = max(1, rays // RAYS)
            shift = 1e-3 * torch.arange(copies, device=dev).repeat_interleave(
                RAYS)[:, None, None]
            xx = (torch.cat([x] * copies) + shift)[:rays].contiguous()
            calls.append(lambda xx=xx, o=o: cm.cost_mapping(None, xx, o, mvs))
        print(f"[scaling] {rays} rays x {SAMPLES} samples: cold "
              f"{np.median(cold_ms(calls)):.4f} ms, warm "
              f"{median_ms(calls[0], backlog=True):.4f} ms", flush=True)


def ptxas() -> None:
    """`nvcc -Xptxas -v` on this checkout's source: registers, spills and
    shared memory of each instantiation."""
    import tempfile
    sys.path.insert(0, REPO)
    from s_volsdf_tpu_torch.ops import cost_mapping as cm
    from s_volsdf_tpu_torch.ops.build import nvcc
    with tempfile.TemporaryDirectory() as tmp:
        flags = [f for f in cm.FLAGS if f not in ("-shared",)]
        res = subprocess.run([nvcc()] + flags + ["-c", "-Xptxas", "-v", "-o",
                              os.path.join(tmp, "cm.o"), cm.SOURCE],
                             capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "ptxas" in line:
            print(f"[ptxas] {line.strip()}", flush=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{res.stderr}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", help="another checkout, timed in turns with "
                    "this one")
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        child(args.child)
        return
    import torch
    if not torch.cuda.is_available():
        sys.exit("time_cost_mapping: no CUDA device; this script runs on a "
                 "GPU")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[card] {card}", flush=True)
    if args.ptxas:
        ptxas()
    if args.scaling:
        scaling()
    trees = [REPO]
    if args.other:
        other = os.path.abspath(args.other)
        trees = [other, REPO, REPO, other] * args.pairs
    runs = []
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--child", tree], capture_output=True,
                             text=True, cwd=tree)
        if res.returncode != 0:
            raise RuntimeError(f"turn {tree} failed:\n{res.stderr[-4000:]}")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print("[time] an empty kernel timed as the cold launches are: "
          + " / ".join(f"{r['floor_ms']:.4f}" for r in runs if "floor_ms" in r)
          + f" ms [{card}]", flush=True)
    for tree in dict.fromkeys(trees):
        mine = [r for r in runs if r["tree"] == tree]
        for dtype in ("bfloat16", "float32"):
            def col(key):
                return " / ".join(f"{r[dtype][key]:.4f}" for r in mine)
            bound = mine[0][dtype]["bound_ms"]
            print(f"[time] {tree}: {dtype} volumes: cold {col('ms_cold')} "
                  f"ms (" + " / ".join(
                      f"{100 * bound / r[dtype]['ms_cold']:.1f}%"
                      for r in mine) + f" of the {bound:.4f} ms bound of "
                  f"the layout it reads; the volumes as the caller holds "
                  f"them {mine[0][dtype]['bytes_unpacked_ms']:.4f} ms), "
                  f"warm {col('ms_warm')} ms, wrapper {col('wrapper_ms')} "
                  f"ms (host and device), "
                  + " / ".join(f"{r[dtype]['wrapper_host_us']:.2f}"
                               for r in mine)
                  + " us host per call; the kernel's copy made in "
                  + " / ".join(f"{r[dtype]['pack_ms']:.1f}" for r in mine
                               if r[dtype]["pack_ms"] is not None)
                  + f" ms [{card}]", flush=True)
    if args.trace:
        trace()


if __name__ == "__main__":
    main()
