"""Device ms a step of the kernels launched inside the text tower, its forward
and its backward (``record_function`` ranges from module hooks)."""

from h100_bench import readers


def read(run):
    return readers.range_ms(run, "text_tower", "text_tower.backward")
