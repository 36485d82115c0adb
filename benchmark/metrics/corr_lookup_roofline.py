"""The correlation lookup kernels' share of their roofline."""

from harness import readers


def read(r):
    return readers.roofline(r, "corr_lookup", readers.CORR_LOOKUP)
