"""kernels.sky_ms.orbit: `kernels.sky_ms` in the host-loop (orbit) cells, where
it moves `frame_ms.orbit`; the reading is kernels.sky_ms.py's."""

from harness.manifest import load_reader

read = load_reader("kernels.sky_ms")
