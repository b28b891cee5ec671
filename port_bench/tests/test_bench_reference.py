"""The reference's frozen copies held equal to what they were copied
from: at a small size on the CPU the port runs its plain paths, and the
reference recomputes the same training steps and render chunks."""

from __future__ import annotations

import pytest

from port_bench.tests.tiny import CELLS, VARIANTS, tiny_cell

TRAIN = [n for n in CELLS + VARIANTS if tiny_cell(n).traffic["entry"] == "train"]
RENDER = [n for n in CELLS if n not in TRAIN]


@pytest.mark.parametrize("name", TRAIN)
def test_training_steps_match_the_port(name):
    cell = tiny_cell(name)
    e = cell.entry(2 ** 31 + 3, "cpu")
    e.setup({})
    e.window(0.0)
    e.finish()
    e.release()
    numbers = e.readings()
    # Adam's first moment divided back by 0.1 rounds; the lockstep step's
    # batched products sum in another order than the serial ones, which
    # moves a bf16 rounding now and then by the third step.
    assert numbers["loss1_rel"] <= 1e-6, numbers
    assert numbers["grad_leaf"] <= 1e-5, numbers
    assert numbers["change_leaf"] <= (1e-5 if e.S == 1 else 1e-2), numbers
    # The tail step, from the program's own state: its gradient comes
    # back from two of Adam's moments, m_after - 0.9 m_before, which
    # rounds more than the first step's.
    assert numbers["tail_replay"] == 0.0, numbers
    assert numbers["tail_loss_rel"] <= 1e-6, numbers
    assert numbers["tail_grad_leaf"] <= 1e-4, numbers
    assert numbers["rgb_grad_median"] <= 1e-4, numbers
    assert numbers["tail_change_leaf"] <= (1e-5 if e.S == 1 else 1e-2), numbers


@pytest.mark.parametrize("name", RENDER)
def test_render_chunks_match_the_port(name):
    cell = tiny_cell(name)
    e = cell.entry(11, "cpu")
    e.setup({})
    e.window(0.0)
    e.release()
    numbers = e.readings()
    assert max(numbers.values()) <= 1e-6, numbers
