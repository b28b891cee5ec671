"""The fused SDF sweep's share of its roofline in the profiled stretch:
the least time the card needs for the points it swept
(arith.fused_sdf_least_seconds: the SDF column's multiply-adds a point,
2 operations each, at the bf16 peak, or the bytes at HBM's rate,
whichever is longer) over the device time of the kernels whose name
holds fused_sdf, in %."""


def read(ctx):
    p = ctx["profile"]
    if ctx["unit"] != "step" or not p or not p["fused_launches"]:
        return None
    seconds = sum(s for name, s in p["kernel_s"].items() if "fused_sdf" in name)
    if seconds <= 0:
        return None
    least = ctx["arith"].fused_sdf_least_seconds(
        ctx["model"], p["fused_points"], p["fused_launches"])
    return 100.0 * least / seconds
