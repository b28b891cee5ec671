"""The check fails what it must: the control (the reference in the
program's place at the next lower precision than the configuration
states) and each fault a cell can have, planted in the program's timed
path under a whole run of the harness, at sizes a CPU test holds."""

from __future__ import annotations

import pytest

from port_bench import calibrate, check, faults, run
from port_bench.tests.tiny import CELLS, tiny_cell

TRAIN = [c for c in CELLS if run.Cell(run.load_spec(), c).traffic["entry"] == "train"]
RENDER = [c for c in CELLS if c not in TRAIN]


@pytest.mark.parametrize("name", TRAIN)
def test_the_control_is_not_correct(name):
    # The render's control is TF32, which the CPU does not have; it is read
    # on the card (calibrate.py, PERF.md §2).
    cell = tiny_cell(name)
    numbers = calibrate.reading(cell, 2 ** 31 + 9, "control", "cpu")["numbers"]
    correct, _ = check.verdict(numbers, cell.limits)
    assert not correct, numbers


@pytest.mark.parametrize("name,fault", [(n, f) for n in TRAIN
                                        for f in ("state_unchanged", "half_batch")]
                         + [(n, "altered_answer") for n in RENDER])
def test_a_run_with_a_fault_is_not_correct(name, fault):
    cell = tiny_cell(name)
    with faults.FAULTS[fault]():
        res = run.run_cell(cell, 2 ** 31 + 21, 0.2, False, "cpu")
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("name", TRAIN)
def test_a_fault_past_a_calls_first_steps_fails_the_tail(name):
    # Every step after a call's first three leaves the state unchanged:
    # the first steps are sound, the tail step (a call's twelfth) is not.
    cell = tiny_cell(name)
    cell.traffic = dict(cell.traffic, tail_steps=5)
    with faults.late_state_unchanged(after=3):
        res = run.run_cell(cell, 2 ** 31 + 23, 0.2, False, "cpu")
    checks = res["checks"]
    assert not res["correct"], checks
    assert checks["change_median"]["value"] <= checks["change_median"]["limit"]
    assert checks["tail_change_median"]["value"] > 0.5, checks


@pytest.mark.cuda
@pytest.mark.parametrize("name", RENDER)
def test_the_render_control_is_not_correct_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is TF32")
    cell = tiny_cell(name)
    cell.config["scene"] = dict(cell.config["scene"], img_res=[64, 96])
    cell.traffic = dict(cell.traffic, chunk=1024, check_chunks=4)
    numbers = calibrate.reading(cell, 2 ** 31 + 9, "control", "cuda")["numbers"]
    correct, _ = check.verdict(numbers, cell.limits)
    assert not correct, numbers


def test_a_nan_reading_is_not_correct():
    # max() with a NaN keeps the other reading: the worst-of must not.
    assert check._worse(0.0, float("nan")) == float("inf")
    assert check._worse(float("nan"), 0.0) == float("inf")
    correct, _ = check.verdict({"loss1_rel": float("nan")}, {"loss1_rel": 0.02})
    assert not correct


def test_a_saturated_colour_mlp_reads_its_rounding_as_nought():
    # On the post-anneal colour plateau the colour MLP's gradient has all
    # but vanished on both sides (on the card 1e-22 in the reference, 1e-19
    # in the program, against a median leaf of 0.019): its gap is rounding.
    # A live colour MLP's gradient, doubled, still reads its gap.
    import types

    import torch
    leaves = [f"sdf.{i}.v" for i in range(5)] + [f"rgb.{i}.v" for i in range(3)]
    P0 = {k: torch.zeros(4, dtype=torch.float64) for k in leaves}
    entry = types.SimpleNamespace(tail_start=[{"params": P0}])

    def tail(sdf: float, rgb: float):
        grad = {k: torch.full((4,), (sdf if k.startswith("sdf") else rgb) / 2,
                              dtype=torch.float64) for k in leaves}
        return [{"losses": [{"loss": 1.0, "rgb_loss": 0.5}], "first_grad": grad,
                 "params": {k: v + 1e-3 for k, v in P0.items()}, "replay": 0.0}]

    numbers = check.tail_numbers(entry, tail(0.02, 1e-19), tail(0.02, 1e-22))
    assert numbers["rgb_grad_median"] < 1e-15, numbers
    numbers = check.tail_numbers(entry, tail(0.02, 0.02), tail(0.02, 0.01))
    assert numbers["rgb_grad_median"] == pytest.approx(0.5), numbers
