"""shadow.tile_rows_max: the most rows one tile of a shadow cascade holds
(its segment and the global list, which every tile walks), the peak of the
program's device counter `shadow/rows` over the window and the traced
units. A program without the counter reads None."""

from harness.counters import counter


def read(r):
    c = counter("shadow/rows")
    return None if c is None else c[2]
