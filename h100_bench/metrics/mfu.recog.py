"""Model FLOPs of the window's passes over its seconds at the bf16 peak, in
percent."""

from h100_bench import readers


def read(run):
    return readers.mfu_pct(run)
