"""Phase timers and the TensorBoard writer's interface (counterpart of
s_volsdf_tpu/utils/tracing.py).

`PhaseTimer.phase(name, trace_dir)` accumulates wall-clock seconds per
named phase and, with a trace_dir, records the phase with
`torch.profiler` (host and CUDA activity) into
<trace_dir>/<name>.json, a Chrome trace, where the JAX package uses
`jax.profiler`. A phase that ends while the card still works is timed
to its last launch, not to its end: callers that time device work
synchronise inside the phase.

`TBWriter` keeps the JAX writer's calls (`scalar`, `image`)
and, as the JAX writer does without tensorboardX, writes nothing: the
card's machine has no tensorboardX, and the port imports none. It logs
that once.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Dict, Optional

import torch

logger = logging.getLogger("s_volsdf_tpu_torch")


class PhaseTimer:
    """Wall-clock seconds and calls per named phase."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def phase(self, name: str, trace_dir: Optional[str] = None):
        prof = None
        if trace_dir:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=acts)
            prof.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            if prof is not None:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                prof.export_chrome_trace(os.path.join(trace_dir,
                                                      f"{name}.json"))
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def report(self) -> Dict[str, float]:
        for name in sorted(self.totals):
            logger.info(
                f"phase {name}: {self.totals[name]:.2f}s total, "
                f"{self.totals[name] / max(self.counts[name], 1):.3f}s avg "
                f"x{self.counts[name]}")
        return dict(self.totals)


class TBWriter:
    """The JAX package's TensorBoard writer without tensorboardX: every
    call is a no-op."""

    _warned = False

    def __init__(self, logdir: Optional[str]):
        if logdir and not TBWriter._warned:
            logger.warning("tensorboard unavailable: the port writes no "
                           f"TensorBoard events (asked for {logdir})")
            TBWriter._warned = True

    def scalar(self, tag: str, value, step: int) -> None:
        pass

    def image(self, tag: str, img_hwc, step: int) -> None:
        pass
