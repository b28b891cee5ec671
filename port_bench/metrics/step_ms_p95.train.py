"""The 95th percentile of the trainer's step times (`step_seconds`, host
seconds a step, each ending in the NaN guard's sync) over every step of
the untraced stretch, in ms."""


def read(ctx):
    if ctx["unit"] != "step":
        return None
    return 1e3 * ctx["arith"].percentile(ctx["stretch"]["unit_seconds"], 95)
