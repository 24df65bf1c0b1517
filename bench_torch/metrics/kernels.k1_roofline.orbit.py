"""kernels.k1_roofline.orbit: `kernels.k1_roofline` in the host-loop (orbit) cells, where it
moves `frame_ms.orbit`; the reading is kernels.k1_roofline.py's."""

from harness.manifest import load_reader

read = load_reader("kernels.k1_roofline")
