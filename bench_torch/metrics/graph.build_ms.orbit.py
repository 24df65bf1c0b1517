"""graph.build_ms.orbit: `graph.build_ms` in the host-loop (orbit) cells, where it
moves `frame_ms.orbit`; the reading is graph.build_ms.py's."""

from harness.manifest import load_reader

read = load_reader("graph.build_ms")
