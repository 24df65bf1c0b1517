"""pt.front_max: the most rays one traversal of the path tracer was given
live (a bounce's closest-hit front, or a bounce's NEE front of two rays a
lane), the peak of the program's device counter `pt/rays` since the
window's start. A program without the counter reads None."""

from harness.counters import counter


def read(r):
    c = counter("pt/rays")
    return None if c is None else c[2]
