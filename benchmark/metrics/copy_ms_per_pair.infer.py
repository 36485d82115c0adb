"""Device time of host-device copies an inferred pair."""

from harness import readers


def read(r):
    return readers.copy_ms_per_pair(r)
