"""The share of the untraced time of the profiled work in which no
operation ran on the device, in percent: 1 - (the union of the device
intervals of the stretch that records the device alone) / (the untraced
time of the same work: the window's own steps, as many as were
profiled). Recording adds CUPTI's cost to each launch, so the profiled
stretch's own wall time would count the profiler as idle time where the
host sets the pace; the device's work a step is what it was."""


def read(ctx):
    p = ctx["profile"]
    if ctx["unit"] != "step" or not p or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["untraced_s"])
