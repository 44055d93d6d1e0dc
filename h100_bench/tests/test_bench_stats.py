"""The window's arithmetic: a rate over all the work and all the time, the
95th percentile over every batch, and the trace's busy, exclusive and idle
time."""

from __future__ import annotations

import random
import statistics

import pytest

from h100_bench import trace as tr
from h100_bench.cell import Window, p95
from h100_bench.loops import recognize, tune


def test_tune_rate_is_all_clouds_over_all_seconds():
    w = Window(elapsed_s=10.0, clouds=30 * 221, units=221, unit_s=[0.045] * 221,
               gap_s=[0.001] * 221)
    assert tune.Loop.end_to_end(None, w) == {"tune_clouds_per_s": 663.0}


def test_recognition_rate_and_tail_over_every_batch():
    rng = random.Random(0)
    unit_s = [rng.uniform(0.010, 0.020) for _ in range(400)] + [0.5] * 30  # a slow tail
    w = Window(elapsed_s=12.0, clouds=3 * 2468, units=len(unit_s), unit_s=unit_s,
               gap_s=[0.0] * len(unit_s), passes=3)
    out = recognize.Loop.end_to_end(None, w)
    assert out["recog_clouds_per_s"] == pytest.approx(3 * 2468 / 12.0)
    # the tail of all batches, not a median of chunks: 30 of 430 are slow
    assert out["recog_batch_ms_p95"] == pytest.approx(500.0)
    assert p95(unit_s) == statistics.quantiles(unit_s, n=100)[94]


def test_busy_is_the_union_and_shares_sum_to_it():
    iv = [(0.0, 10.0), (5.0, 12.0), (20.0, 25.0), (21.0, 22.0)]
    assert tr.busy_us(iv) == 17.0
    shares = tr.exclusive_us(iv)
    assert shares == [10.0, 2.0, 5.0, 0.0]
    assert sum(shares) == tr.busy_us(iv)
    assert tr.idle_gaps(iv, -1.0, 30.0) == [(-1.0, 0.0), (12.0, 20.0), (25.0, 30.0)]


def test_parts_group_kernels_by_name():
    assert tr.part_of("void ppt::fps_batched_kernel<4>(float const*)") == "fps_batched"
    assert tr.part_of("ampere_bf16_s16816gemm_bf16_128x64") == tr.OTHER


def test_ranges_attribute_kernels_by_launch():
    k = [tr.Kernel("a", 0, 1, ("step", "point_tower"), 1.0),
         tr.Kernel("b", 1, 3, ("step", "point_tower", "point_tower.encoder"), 2.0),
         tr.Kernel("c", 3, 4, ("step",), 1.0)]
    t = tr.Trace(units=2, wall_s=1.0, kernels=k, annotations=[], slice_range=(0, 4))
    assert t.range_us("point_tower") == 3.0
    assert t.range_us("point_tower", exclude_children=True) == 1.0
    assert t.by_range()["step"] == pytest.approx(4.0 / 1e3 / 2)
