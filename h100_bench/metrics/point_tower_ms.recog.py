"""Device ms a batch of the kernels launched inside the point tower."""

from h100_bench import readers


def read(run):
    return readers.range_ms(run, "point_tower")
