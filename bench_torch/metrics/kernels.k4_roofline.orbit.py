"""kernels.k4_roofline.orbit: `kernels.k4_roofline` in the host-loop (orbit) cells, where it
moves `frame_ms.orbit`; the reading is kernels.k4_roofline.py's."""

from harness.manifest import load_reader

read = load_reader("kernels.k4_roofline")
