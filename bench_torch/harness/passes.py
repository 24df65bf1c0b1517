"""The frame graph's per-pass spans, as the per-layer readers read them.

The program's PROFILER opens the span `pass/<name>` around every pass of a
frame (`Graph._run_passes`): its host enqueue time, summed in `totals()`,
and on the card its device time from a pair of timing events, summed in
`device_totals()` (in a captured loop, the last replayed frame of each
`run_on_device` call). The harness resets the PROFILER at the measured
window's start, so the device figures cover the window and the traced
units. A program without the spans reads None."""

from __future__ import annotations

import importlib

from harness.session import PROGRAM

# The passes of the RASTERIZED frame with ray-traced shadows, in order
# (renderers/__init__.py::build_render_graph).
PASSES = ("shadow", "gbuffer", "rt_shadows", "rt_reflections", "ssao", "deferred",
          "atmosphere", "present")


def device_totals() -> dict:
    """scope -> (frames sampled, total device ms) of the program's
    PROFILER; {} where it keeps no device spans."""
    profiler = importlib.import_module(f"{PROGRAM}.utils.profiler").PROFILER
    read = getattr(profiler, "device_totals", None)
    return read() if read is not None else {}


def device_ms(name: str) -> float | None:
    """Pass `name`'s device ms a sampled frame, or None without samples."""
    frames, ms = device_totals().get(f"pass/{name}", (0, 0.0))
    return ms / frames if frames else None


def host_ms(r, name: str) -> float | None:
    """Pass `name`'s host enqueue ms a frame of the measured window: its
    span's total over the window's frames, as `app.enqueue_ms` reads the
    frame's scope; None without the span."""
    calls, ms = r.profiler_totals.get(f"pass/{name}", (0, 0.0))
    if not calls or not r.window_frames:
        return None
    return ms / r.window_frames


def passes_device_ms() -> float | None:
    """The device ms a frame of all of PASSES, or None where one has no
    samples."""
    each = [device_ms(p) for p in PASSES]
    return None if None in each else sum(each)
