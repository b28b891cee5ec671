"""What every entry shares: timing the set-up's parts, the synchronise
that ends a stretch, the port's Config from a configuration file, and
the profiling of a stretch.

Of the benchmark, the entries (`entries/`), `run.build_program` and
`faults.py` import the program, `s_volsdf_tpu_torch`, and they take only
its entries, its dataclasses and parameter names, its counters and its
build.
"""

from __future__ import annotations

import dataclasses
import time
from contextlib import contextmanager
from typing import Callable, Dict

import torch

from port_bench.trace import reduce_profile


@contextmanager
def timed(parts: Dict[str, float], name: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        parts[name] = parts.get(name, 0.0) + time.perf_counter() - t0


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def port_config(doc: Dict):
    """The port's Config with every value of the configuration file's
    "config" group set on its defaults; a key the port lacks raises."""
    from s_volsdf_tpu_torch.config import Config, check_ported

    def put(obj, values: Dict, where: str) -> None:
        for k, v in values.items():
            if not dataclasses.is_dataclass(obj) or not hasattr(obj, k):
                raise KeyError(f"the port's config has no {where}{k}")
            cur = getattr(obj, k)
            if isinstance(v, dict):
                put(cur, v, f"{where}{k}.")
            else:
                setattr(obj, k, tuple(v) if isinstance(v, list) else v)

    cfg = Config()
    put(cfg, doc["config"], "")
    return check_ported(cfg)


def _stretch(fn: Callable[[], None], device, host: bool, span: str):
    """fn() under torch.profiler, ended in a synchronise: (its wall
    seconds, `reduce_profile` of the trace). With `host` the profiler
    records the host's operations too, inside the host span `span`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        if host:
            with record_function(span):
                fn()
                sync(device)
        else:
            fn()
            sync(device)
        wall = time.perf_counter() - t0
    return wall, reduce_profile(prof)


def profile(fn: Callable[[], None], units: int, untraced_s: float,
            device, span: str, counter: Callable[[], int]) -> Dict:
    """Two profiled stretches of `units` units each (fn() runs one
    stretch), after an untraced stretch of the same work that took
    `untraced_s`. The first records the device alone: the busy time,
    the stretch's length, the operations and the device time by kernel
    come from it. The second records the host too, and gives only the
    labels of the idle gaps (the innermost host operation or span open
    when each opened). Recording slows a host-paced stretch (CUPTI's
    record of each launch, even with the device alone), while the
    device's work is what it was, so "untraced_s" is kept beside them
    and each stretch's time a unit is printed. `counter()` is read
    around the first stretch, and its growth there is "counted"."""
    if torch.device(device).type != "cuda":
        raise RuntimeError("a traced run measures the card: it needs CUDA")
    before = counter()
    wall, out = _stretch(fn, device, False, span)
    out["counted"] = counter() - before
    if out["busy_s"] <= 0:
        raise RuntimeError("the profiler saw no device work in the stretch")
    wall_host, labelled = _stretch(fn, device, True, span)
    out.update({"units": units, "window_s": wall, "untraced_s": untraced_s,
                "idle_gaps": labelled["idle_gaps"]})
    print(f"[trace] device-only stretch {wall:.3f} s, {out['launches']} device "
          f"operations, busy {out['busy_s']:.3f} s; a {span} unit "
          f"{1e3 * wall / units:.3f} ms there, {1e3 * wall_host / units:.3f} ms "
          f"with the host recorded, {1e3 * untraced_s / units:.3f} ms untraced",
          flush=True)
    return out
