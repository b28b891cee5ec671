"""Device operations (kernels, copies and sets) a step launched in the
profiled stretch."""


def read(ctx):
    p = ctx["profile"]
    if ctx["unit"] != "step" or not p or not p["launches"]:
        return None
    return p["launches"] / p["units"]
