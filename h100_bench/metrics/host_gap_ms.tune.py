"""Host ms a step outside the step call: the loader, ``cls.device_batch`` and
``train_augment`` (the window's host spans)."""

from h100_bench import readers


def read(run):
    return readers.host_gap_ms(run)
