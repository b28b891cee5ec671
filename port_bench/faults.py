"""Faults planted in the program's timed path, to show that the check
fails them: a step that leaves its state unchanged (from a call's first
step, or only past a call's first steps), half of each batch left out of
every mean, an answer altered where it is produced. Each is a context
manager that patches the program and restores it."""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(obj, name: str, value):
    saved = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, saved)


@contextlib.contextmanager
def state_unchanged():
    """Every optimizer step returns without touching the parameters or
    Adam's state."""
    from s_volsdf_tpu_torch.engine import train_step
    with _patched(train_step.Optimizer, "apply", lambda self, *a: None), \
            _patched(train_step.StackedOptimizer, "apply", lambda self, *a: None):
        yield


@contextlib.contextmanager
def late_state_unchanged(after: int = 3):
    """Every optimizer step after a call's first `after` returns without
    touching the parameters or Adam's state."""
    from s_volsdf_tpu_torch.engine import multiscene, train_step, trainer
    count = [0]

    def counted(fn):
        def call(*a, **kw):
            count[0] = 0
            return fn(*a, **kw)
        return call

    def late(fn):
        def apply(self, *a):
            count[0] += 1
            if count[0] <= after:
                return fn(self, *a)
        return apply

    with _patched(multiscene, "run_joint", counted(multiscene.run_joint)), \
            _patched(trainer.VolTrainer, "run", counted(trainer.VolTrainer.run)), \
            _patched(train_step.Optimizer, "apply", late(train_step.Optimizer.apply)), \
            _patched(train_step.StackedOptimizer, "apply",
                     late(train_step.StackedOptimizer.apply)):
        yield


@contextlib.contextmanager
def half_batch():
    """Every per-ray mean of the loss is taken over the first half of
    each scene's rays only."""
    from s_volsdf_tpu_torch.models import loss

    def mean(x, S):
        if not S:
            return x[: x.shape[0] // 2].mean()
        rows = x.reshape(S, -1)
        return rows[:, : rows.shape[1] // 2].mean(dim=1)

    with _patched(loss, "_mean", mean):
        yield


@contextlib.contextmanager
def altered_answer(delta: float = 0.25):
    """The first ray of every chunk an eval render draws comes back with
    its colour moved by `delta`."""
    from s_volsdf_tpu_torch.engine import render
    orig = render.render_rays

    def rays(*args, **kw):
        out = orig(*args, **kw)
        rgb = out.rgb_values.clone()
        rgb[0] += delta
        return out._replace(rgb_values=rgb)

    with _patched(render, "render_rays", rays):
        yield


FAULTS = {"state_unchanged": state_unchanged,
          "late_state_unchanged": late_state_unchanged, "half_batch": half_batch,
          "altered_answer": altered_answer}
