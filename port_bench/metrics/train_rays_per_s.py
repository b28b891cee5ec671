"""Training rays a second over the window: scenes x rays a step x the
steps of the window's one call, over the call's wall time (ended by a
synchronise)."""


def read(ctx):
    s = ctx["stretch"]
    if ctx["unit"] != "step" or not s["units"]:
        return None
    return s["rays"] / s["seconds"]
