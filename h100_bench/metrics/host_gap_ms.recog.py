"""Host ms a batch outside the model call, from the eval step's return (the
call closed by a synchronise in the traced run) to the next call or the pass's end."""

from h100_bench import readers


def read(run):
    return readers.host_gap_ms(run)
