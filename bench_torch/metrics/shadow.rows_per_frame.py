"""shadow.rows_per_frame: the binned rows K4 walks in a frame, each
cascade's tile segments and its global list summed over the cascades, from
the program's device counter `shadow/rows` (one call a frame, replays
included), over the window and the traced units. A program without the
counter reads None."""

from harness.counters import counter


def read(r):
    c = counter("shadow/rows")
    return None if c is None else c[1] / c[0]
