"""The instance norm kernel's share of its roofline in training."""

from harness import readers


def read(r):
    return readers.roofline(r, "instance_norm", readers.INSTANCE_NORM)
