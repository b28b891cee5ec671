"""The whole step's share of the card's bf16 peak over the untraced
stretch: the operations the configuration fixes for a step
(arith.train_step_flops) times the steps
completed, over the stretch's host time, over 989 TFLOP/s, in %."""


def read(ctx):
    s = ctx["stretch"]
    if ctx["unit"] != "step" or not s["units"]:
        return None
    rate = ctx["flops_per_unit"] * s["units"] / s["seconds"]
    return 100.0 * rate / ctx["arith"].PEAK_FLOPS
