"""kernels.ssao_ms.orbit: `kernels.ssao_ms` in the host-loop (orbit) cells,
where it moves `frame_ms.orbit`; the reading is kernels.ssao_ms.py's."""

from harness.manifest import load_reader

read = load_reader("kernels.ssao_ms")
