"""Device kernels a batch in the profiled pass (its text encode included)."""

from h100_bench import readers


def read(run):
    return readers.launches(run)
