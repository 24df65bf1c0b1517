"""app.enqueue_ms.orbit: `app.enqueue_ms` in the host-loop (orbit) cells, where it
moves `frame_ms.orbit`; the reading is app.enqueue_ms.py's."""

from harness.manifest import load_reader

read = load_reader("app.enqueue_ms")
