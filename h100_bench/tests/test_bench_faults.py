"""Every cell driven end to end on the CPU at tiny widths, with the look for
a card skipped: a sound run comes out correct, and each fault the cell can
have, planted underneath the timed path, comes out not correct.

The limits are the committed ones (``h100_bench/limits/``), set from the
card's bf16 runs; the CPU runs the program in f32, far inside them.
"""

from __future__ import annotations

import time

import pytest
import torch

from h100_bench import cell

torch.set_num_threads(2)

FAULTS = {"ppt_base.tune": ["unchanged", "half_batch", "altered_answer"]}
CASES = [(c, None) for c in FAULTS] + [(c, f) for c, fs in FAULTS.items() for f in fs]


def run(root, name, fault=None, trace=False, seed=123456789012):
    ctx = cell.load(root, name, seed, 0.05, trace, "cpu")
    ctx.fault = fault
    return cell.execute(ctx, time.perf_counter())


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{c}-{f}" for c, f in CASES])
def test_fault_is_caught(tiny_root, name, fault):
    out = run(tiny_root, name, fault)
    assert out["correct"] is (fault is None), out["checks"]
