"""The program's device counters, as the per-layer readers read them.

The program's PROFILER keeps counters on the device (`count`): a frame adds
to them with device operations only, so a captured frame counts in every
replay, and `counters()` reads them, waiting for the device. The harness
resets the PROFILER at the measured window's start, so a counter covers the
window and the traced units. A program without counters, or without this
one, reads None."""

from __future__ import annotations

import importlib

from harness.session import PROGRAM


def counter(name: str) -> tuple[int, int, int] | None:
    """(calls, total, peak) of the program's counter `name`, or None where
    it has no such counter or it was not called."""
    profiler = importlib.import_module(f"{PROGRAM}.utils.profiler").PROFILER
    read = getattr(profiler, "counters", None)
    calls, total, peak = (read() if read is not None else {}).get(name, (0, 0, 0))
    return (calls, total, peak) if calls else None
