"""kernels.torch_ms.orbit: `kernels.torch_ms` in the host-loop (orbit) cells, where it
moves `frame_ms.orbit`; the reading is kernels.torch_ms.py's."""

from harness.manifest import load_reader

read = load_reader("kernels.torch_ms")
