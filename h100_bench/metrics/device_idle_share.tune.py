"""Percent of the profiled steps' wall time in which the device ran nothing."""

from h100_bench import readers


def read(run):
    return readers.idle_pct(run)
