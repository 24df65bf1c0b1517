"""pt.ended_per_frame: the lanes the path tracer ends in a frame because
their scattered direction is zero or not finite, from the program's device
counter `pt/ended` (one call a frame, replays included), its total over its
calls since the window's start. A program without the counter reads
None."""

from harness.counters import counter


def read(r):
    c = counter("pt/ended")
    return None if c is None else c[1] / c[0]
