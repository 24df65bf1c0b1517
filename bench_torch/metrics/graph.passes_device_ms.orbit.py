"""graph.passes_device_ms.orbit: the device ms a frame of the eight passes' spans
together (each pass's event pairs over its frames sampled, summed), in the
host-loop (orbit) cells. Less the device's busy time it is the idle time
inside the passes, where the host's launches starve the card; taken from
`frame_ms.orbit` it is the frame's time outside any pass."""

from harness import passes


def read(r):
    return passes.passes_device_ms()
