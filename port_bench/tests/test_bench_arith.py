"""The operation counts behind mfu.* and the fused-SDF roofline, held
to torch's FlopCounterMode over the plain reference at a few rays, and
the percentile and interval arithmetic."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from port_bench import arith, inputs
from port_bench.reference import volsdf as ref
from port_bench.tests.tiny import tiny_cell

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(__file__)), "configs")


def _cfg(name):
    if name == "volsdf_bmvs":     # the port's BlendedMVS configuration
        return tiny_cell("serial_bmvs").config["config"]
    with open(os.path.join(CONFIGS, name + ".json")) as f:
        return json.load(f)["config"]


def _scene():
    sc = inputs.sphere_scene((16, 24), 0.8, "cpu", inputs.view_angles(3))
    rgb = sc["images"].reshape(3, -1, 3)
    return sc, {"rgb": rgb, "rgb_smooth": rgb, "poses": sc["poses"],
                "K": sc["K"], "img_res": (16, 24)}


def _matmul_flops(fc) -> int:
    return sum(v for k, v in fc.get_flop_counts()["Global"].items()
               if str(k).split(".")[-1] in ("mm", "addmm"))


def test_sdf_multiply_adds_at_the_dtu_widths():
    # The issue's 459,264 pads the encoding's 39 inputs to 40 (the
    # kernel's layout); the work is 39 x 256 in the first layer.
    assert arith.sdf_macs_col(_cfg("volsdf_dtu")["model"]) == 459_008


@pytest.mark.parametrize("name", ["volsdf_dtu", "volsdf_bmvs"])
def test_train_step_count_equals_the_reference_step(name):
    cfg = _cfg(name)
    R = 8
    cfg["train"]["num_pixels"] = R
    P = inputs.init_weights(cfg["model"], torch.Generator().manual_seed(0), "cpu")
    _, scene = _scene()
    with FlopCounterMode(display=False) as fc:
        ref.train_steps(P, cfg, scene, None, torch.Generator().manual_seed(1),
                        1, ref.train_model_prec(cfg))
    assert arith.train_step_flops(cfg["model"], R) == _matmul_flops(fc)


def test_view_count_is_never_above_the_reference_view():
    cfg = _cfg("volsdf_dtu")
    m = cfg["model"]
    P = inputs.init_weights(m, torch.Generator().manual_seed(0), "cpu")
    sc, _ = _scene()
    R = 8
    uv = torch.stack([torch.arange(R).float(), torch.full((R,), 8.0)], -1)
    with FlopCounterMode(display=False) as fc:
        ref.render_pixels(P, m, sc["poses"][0], sc["K"][0], uv,
                          ref.eval_model_prec(cfg), 1)
    one_sweep = _matmul_flops(fc)
    # With one sampler iteration the reference does exactly what is counted.
    assert arith.view_flops(m, R) == one_sweep
    with FlopCounterMode(display=False) as fc:
        ref.render_pixels(P, m, sc["poses"][0], sc["K"][0], uv,
                          ref.eval_model_prec(cfg), m["sampler"]["max_total_iters"])
    assert arith.view_flops(m, R) <= _matmul_flops(fc)


def test_roofline_bound_is_the_larger_of_operations_and_bytes():
    m = _cfg("volsdf_dtu")["model"]
    pts = 65_536
    ops = 2 * 459_008 * pts / arith.PEAK_FLOPS
    assert arith.fused_sdf_least_seconds(m, pts, 1) == pytest.approx(ops)
    assert arith.fused_sdf_least_seconds(m, 1, 1000) > 2 * 1000 * 400_000 / 3.35e12


def test_percentile_and_union():
    xs = list(np.random.default_rng(0).normal(size=101))
    for q in (50, 95, 99):
        assert arith.percentile(xs, q) == pytest.approx(np.percentile(xs, q))
    assert arith.union_length([(0, 2), (1, 3), (5, 6), (5.5, 5.7)]) == 4


def test_idle_gaps_are_labelled_by_the_innermost_open_host_event():
    from port_bench.trace import _labels
    host = [(0, 100, "run"), (1, 2, "a"), (3, 10, "b"), (4, 5, "c"), (20, 30, "d")]
    assert _labels(host, [1.5, 4.5, 6, 15, 25, 150]) == [
        "a", "c", "b", "run", "d", "host"]
