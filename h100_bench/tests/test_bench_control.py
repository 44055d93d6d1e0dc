"""The control comes out not correct: the plain reference put in the
program's place and computed in fp8, the precision below the
configuration's bfloat16, fails one of the cell's committed limits.

On the card (``card`` marker) at the cell's own size, with the program's
own readings inside the limits; on the CPU at tiny widths, where the limits
do not apply, the control departs from the reference far more than the
program does.
"""

from __future__ import annotations

import pytest
import torch

from h100_bench import cell, control

torch.set_num_threads(2)

CELLS = ["ppt_base.tune"]


def readings(ctx):
    read = control.tune_readings if ctx.traffic["loop"] == "tune" else control.recognize_readings
    return read(ctx)


def fails(numbers, limits) -> bool:
    """Whether a number the limits name reads above its limit."""
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [17, 2**31 + 11, 987654321])
def test_control_departs_at_tiny_widths(tiny_root, name, seed):
    """At tiny widths the committed limits (set at the cell's size) do not
    apply; the fp8 control still departs from the f32 reference by orders of
    magnitude more than the f32 program does."""
    ctx = cell.load(tiny_root, name, seed, 0.0, False, "cpu")
    r = readings(ctx)
    assert max(r["control"].values()) > 1e3 * max(r["program"].values()), r
    assert not fails(r["program"], ctx.limits), r


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_on_the_card(card, name):
    ctx = cell.load(control.ROOT, name, 3000017, 0.0, False, card)
    r = readings(ctx)
    assert fails(r["control"], ctx.limits), r
    assert not fails(r["program"], ctx.limits), r
