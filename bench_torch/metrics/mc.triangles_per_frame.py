"""mc.triangles_per_frame: the isosurface's live triangles a frame (of
5 x grid^3 slots), from the program's device counter `mc/triangles` (one
call a frame, in the extraction pass), its total over its calls since the
window's start. A program without the counter reads None."""

from harness.counters import counter


def read(r):
    c = counter("mc/triangles")
    return None if c is None else c[1] / c[0]
