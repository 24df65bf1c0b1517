"""graph.kernels_per_frame.orbit: `graph.kernels_per_frame` in the host-loop (orbit) cells, where it
moves `frame_ms.orbit`; the reading is graph.kernels_per_frame.py's."""

from harness.manifest import load_reader

read = load_reader("graph.kernels_per_frame")
