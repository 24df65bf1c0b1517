"""Profiling: named scopes with host timers, and device traces.

The port of the JAX package's ``utils/profiler.py``, the analog of the
reference's two-level profiler (SURVEY.md §5.1):
- puffin CPU scopes -> `scope()` host timers summed per name;
- gpu-profiler timestamp queries -> each scope is also a
  `torch.profiler.record_function` range and an NVTX range, so it names its
  span in a `trace()` of the card (and in any CUDA profiler);
- the puffin_egui window -> `report()`, a text table; `trace()` wraps
  `torch.profiler.profile` over the CPU and the card and writes a Chrome
  trace.

A scope never synchronizes the device: its host time is the time to
enqueue the work in it, as the JAX package's scope times the dispatch.
Toggled at run time like the reference's Q key (main.rs:450-453).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


class Profiler:
    def __init__(self) -> None:
        self.enabled = True
        self.paused = False
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        self._frame_started = 0.0
        self.last_frame_ms = 0.0

    def toggle(self) -> None:
        self.enabled = not self.enabled

    def reset(self) -> None:
        """Forget every scope's totals."""
        self._totals.clear()
        self._counts.clear()

    @contextlib.contextmanager
    def scope(self, name: str):
        """A named range (torch.profiler and NVTX), timed on the host clock
        while the profiler is enabled and not paused."""
        with torch.profiler.record_function(name), _nvtx(name):
            if not self.enabled or self.paused:
                yield
                return
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self._totals[name] += time.perf_counter() - t0
                self._counts[name] += 1

    def new_frame(self) -> None:
        now = time.perf_counter()
        if self._frame_started:
            self.last_frame_ms = (now - self._frame_started) * 1000.0
        self._frame_started = now

    def totals(self) -> dict[str, tuple[int, float]]:
        """scope -> (calls, total ms), largest total first."""
        return {name: (self._counts[name], self._totals[name] * 1000.0)
                for name in sorted(self._totals, key=self._totals.get, reverse=True)}

    def report(self) -> str:
        lines = [f"{'scope':<32}{'calls':>8}{'total ms':>12}{'avg ms':>10}"]
        for name, (count, total) in self.totals().items():
            lines.append(f"{name:<32}{count:>8}{total:>12.2f}{total / count:>10.2f}")
        return "\n".join(lines)

    @contextlib.contextmanager
    def trace(self, log_dir: str):
        """A torch.profiler trace of the CPU and, where there is one, the
        card, written to `log_dir`/trace.json (Chrome trace format)."""
        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=activities) as prof:
            yield prof
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _nvtx(name: str):
    """An NVTX range where torch has a GPU, else nothing."""
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


PROFILER = Profiler()
