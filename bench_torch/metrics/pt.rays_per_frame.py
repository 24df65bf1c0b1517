"""pt.rays_per_frame: the rays the path tracer traces in a frame (each
bounce's live closest-hit rays and two NEE rays a lane still going), from
the program's device counter `pt/rays` (one call a frame, replays
included), its total over its calls since the window's start. A program
without the counter reads None."""

from harness.counters import counter


def read(r):
    c = counter("pt/rays")
    return None if c is None else c[1] / c[0]
