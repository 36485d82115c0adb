"""Share of an untraced training step's time with the card idle (its busy
time from the trace)."""

from harness import readers


def read(r):
    return readers.idle_pct(r)
