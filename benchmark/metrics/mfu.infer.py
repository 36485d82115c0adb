"""An untraced inference call's model FLOPs over its time, against the bf16
peak."""

from harness import readers


def read(r):
    return readers.mfu(r)
