"""The flash backward kernels' share of their roofline."""

from harness import readers


def read(r):
    return readers.roofline(r, "flash_bwd", readers.FLASH_BWD)
