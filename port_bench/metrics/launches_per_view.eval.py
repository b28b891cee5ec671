"""Device operations (kernels, copies and sets) a view launched in the
profiled stretch."""


def read(ctx):
    p = ctx["profile"]
    if ctx["unit"] != "view" or not p or not p["launches"]:
        return None
    return p["launches"] / p["units"]
