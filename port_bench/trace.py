"""What a torch.profiler trace of a stretch says: the device's busy time
(the union of its kernels' and copies' intervals), the operations it
launched, the device time by kernel name, and the idle gaps between
device work, each labelled by the innermost host operation or span under
way when it opened (the benchmark's span around its call when no
operation is: the host is in Python)."""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple

from port_bench.arith import merge_intervals

TOP = 10


def reduce_profile(prof) -> Dict:
    """busy_s, launches, kernel_s {name: s}, device_ops and idle_gaps
    ([[name, s]], the TOP largest) of a finished profiler run."""
    from torch.autograd import DeviceType
    dev: List[Tuple[float, float, str]] = []
    host: List[Tuple[float, float, str]] = []
    events = list(prof.events())
    spans = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    for e in events:
        span = (e.time_range.start, e.time_range.end, e.name)
        if e.device_type == DeviceType.CUDA:
            # A host span's image on the device timeline is no work.
            if not (getattr(e, "is_user_annotation", False) or e.name in spans):
                dev.append(span)
        elif e.device_type == DeviceType.CPU:
            host.append(span)
    merged = merge_intervals((a, b) for a, b, _ in dev)
    by_name: Dict[str, float] = defaultdict(float)
    for a, b, name in dev:
        by_name[name] += (b - a) * 1e-6
    gaps: Dict[str, float] = defaultdict(float)
    opens = [end for _, end in merged[:-1]]
    for (_, end), (start, _), label in zip(merged, merged[1:],
                                           _labels(host, opens)):
        gaps[label] += (start - end) * 1e-6
    return {"busy_s": sum(b - a for a, b in merged) * 1e-6,
            "launches": len(dev), "kernel_s": dict(by_name),
            "device_ops": _top(by_name), "idle_gaps": _top(gaps)}


def _labels(host: List[Tuple[float, float, str]],
            times: List[float]) -> List[str]:
    """For each of the ascending `times`, the innermost host event open
    then (of the events open, the latest to start), or "host": one sweep
    over the events in order of their start, with the open ones on a
    stack."""
    host = sorted(host)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "host")
    return out


def _top(d: Dict[str, float]) -> List[List]:
    return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

