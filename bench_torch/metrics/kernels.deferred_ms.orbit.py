"""kernels.deferred_ms.orbit: `kernels.deferred_ms` in the host-loop (orbit)
cells, where it moves `frame_ms.orbit`; the reading is kernels.deferred_ms.py's."""

from harness.manifest import load_reader

read = load_reader("kernels.deferred_ms")
