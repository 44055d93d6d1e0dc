"""The port's kernels' pieces of a train step at their roofline, in percent of
their device time (``arch.<family>.pieces``)."""

from h100_bench import readers


def read(run):
    return readers.roofline_pct(run, "tune")
