"""Eval rays a second over the window: the pixels of every view that
completed in the window, over the time from the window's start to the
end of the last of them."""


def read(ctx):
    s = ctx["stretch"]
    if ctx["unit"] != "view" or not s["units"]:
        return None
    return s["rays"] / s["seconds"]
