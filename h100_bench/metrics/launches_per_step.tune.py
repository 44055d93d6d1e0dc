"""Device kernels a train step in the profiled slice."""

from h100_bench import readers


def read(run):
    return readers.launches(run)
