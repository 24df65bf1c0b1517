"""kernels.k4_ms.orbit: `kernels.k4_ms` in the host-loop (orbit) cells, where it
moves `frame_ms.orbit`; the reading is kernels.k4_ms.py's."""

from harness.manifest import load_reader

read = load_reader("kernels.k4_ms")
