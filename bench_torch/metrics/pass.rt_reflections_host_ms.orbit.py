"""pass.rt_reflections_host_ms.orbit: the `rt_reflections` pass's host enqueue ms a frame in the
host-loop (orbit) cells, from its `pass/rt_reflections` span summed over the measured
window and divided by its frames (`app.enqueue_ms`'s arithmetic)."""

from harness import passes


def read(r):
    return passes.host_ms(r, "rt_reflections")
