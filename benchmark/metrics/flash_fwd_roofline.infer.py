"""The flash forward kernels' share of their roofline in inference."""

from harness import readers


def read(r):
    return readers.roofline(r, "flash_fwd", readers.FLASH_FWD)
