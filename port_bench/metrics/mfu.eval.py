"""The whole view's share of the card's bf16 peak over the untraced
stretch: the operations the configuration fixes for a view
(arith.view_flops) times the views
completed, over the stretch's host time, over 989 TFLOP/s, in %."""


def read(ctx):
    s = ctx["stretch"]
    if ctx["unit"] != "view" or not s["units"]:
        return None
    rate = ctx["flops_per_unit"] * s["units"] / s["seconds"]
    return 100.0 * rate / ctx["arith"].PEAK_FLOPS
