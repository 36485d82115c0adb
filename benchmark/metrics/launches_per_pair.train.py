"""Kernel launches a trained pair."""

from harness import readers


def read(r):
    return readers.launches_per_pair(r)
