"""Profiling: named scopes with host timers and device spans, and device
traces.

The port of the JAX package's ``utils/profiler.py``, the analog of the
reference's two-level profiler (SURVEY.md §5.1):
- puffin CPU scopes -> `scope()` host timers summed per name; each scope is
  also a `torch.profiler.record_function` range and an NVTX range, so it
  names its span in a `trace()` of the card (and in any CUDA profiler);
- gpu-profiler timestamp queries (`Graph::begin_gpu_scope` /
  `end_gpu_scope`, graph.rs:1083-1125) -> a scope given a CUDA device also
  records a timing event on the current stream at its start and at its
  end; the frame graph opens one around every pass (`pass/<name>`). The
  pairs are read once both events have run (`new_frame`,
  `device_totals`), never by waiting. In a stream being captured into a
  CUDA graph the pair's events are external, so the capture records them
  and every replay records them again: the captured loop reads them after
  its replays (`queue`). A scope opened inside another takes its
  enclosing scope's place for captured pairs, so a pass body's own scopes
  (`shadow/bin` in `pass/shadow`) are read from replays too;
- counters kept on the device (`count`): a frame adds to them with device
  operations only, so a captured frame counts in every replay; they are
  read, waiting for the device, after the frames (`counters`);
- the puffin_egui window -> `report()`, a text table of both; `trace()`
  wraps `torch.profiler.profile` over the CPU and the card and writes a
  Chrome trace.

A scope never synchronizes the device: its host time is the time to
enqueue the work in it, as the JAX package's scope times the dispatch.
Toggled at run time like the reference's Q key (main.rs:450-453); while
disabled a scope times nothing and makes no event.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from collections import defaultdict

import torch

# Event pairs waiting to be read; the oldest are dropped beyond this (a
# frame queues one pair a pass, and each frame start reads what has run).
PENDING_SPANS = 4096


class Profiler:
    def __init__(self) -> None:
        self.enabled = True
        self._totals: dict[str, float] = defaultdict(float)
        self._counts: dict[str, int] = defaultdict(int)
        # Device spans: (name, start event, end event) pairs not yet read,
        # and per name the device ms and the spans read.
        self._pending: collections.deque = collections.deque(maxlen=PENDING_SPANS)
        self._device_ms: dict[str, float] = defaultdict(float)
        self._device_counts: dict[str, int] = defaultdict(int)
        # The `spans` of each open scope, innermost last.
        self._open: list = []
        # Device counters: name -> (3,) int64 (calls, total, peak).
        self._counters: dict[str, torch.Tensor] = {}

    def toggle(self) -> None:
        self.enabled = not self.enabled

    def reset(self) -> None:
        """Forget every scope's totals and the device spans not yet read,
        and zero the counters (in place, on their devices: a captured frame
        holds them)."""
        self._totals.clear()
        self._counts.clear()
        self._pending.clear()
        self._device_ms.clear()
        self._device_counts.clear()
        for c in self._counters.values():
            c.zero_()

    @contextlib.contextmanager
    def scope(self, name: str, *, device: torch.device | None = None,
              spans: list | None = None):
        """A named range (torch.profiler and NVTX), timed on the host clock
        while the profiler is enabled. With `device` a CUDA device, its
        device time too: a timing event on the current stream at its start
        and at its end, the pair queued to be read once it has run. While
        the current stream is being captured, the events are external and
        the pair goes to `spans` (a list) instead; without `spans` a
        scope takes its enclosing scope's, and a captured scope with none
        makes no event."""
        with torch.profiler.record_function(name), _nvtx(name):
            if not self.enabled:
                yield
                return
            if spans is None and self._open:
                spans = self._open[-1]
            events = _start_events(device, spans)
            self._open.append(spans)
            t0 = time.perf_counter()
            try:
                yield
                if events is not None:
                    start, end, captured = events
                    end.record()
                    (spans if captured else self._pending).append((name, start, end))
            finally:
                self._open.pop()
                self._totals[name] += time.perf_counter() - t0
                self._counts[name] += 1

    def count(self, name: str, value: torch.Tensor, peak: torch.Tensor) -> None:
        """One call of the counter `name`: its calls + 1, its total +
        `value`, its peak the larger of itself and `peak` (integer scalars on
        one device), by operations on that device alone, so that a captured
        frame counts in every replay. Nothing while disabled."""
        if not self.enabled:
            return
        c = self._counters.get(name)
        if c is None or c.device != value.device:
            c = self._counters[name] = torch.zeros(3, dtype=torch.int64, device=value.device)
        c[0].add_(1)
        c[1].add_(value)
        torch.maximum(c[2], peak, out=c[2])

    def counters(self) -> dict[str, tuple[int, int, int]]:
        """counter -> (calls, total, peak) since the last reset; waits for
        the device."""
        return {name: tuple(c.tolist()) for name, c in self._counters.items()}

    def queue(self, spans: list) -> None:
        """Queue event pairs that a captured scope recorded (`scope`'s
        `spans`), after a replay has recorded them: they are read like
        eager pairs. A pair still queued is not queued twice (its events
        hold the last replay's times)."""
        for span in spans:
            if span not in self._pending:
                self._pending.append(span)

    def _drain(self) -> None:
        """Read the queued pairs whose end event has run, without waiting;
        the others stay queued."""
        waiting = []
        while self._pending:
            name, start, end = span = self._pending.popleft()
            if end.query():
                self._device_ms[name] += start.elapsed_time(end)
                self._device_counts[name] += 1
            else:
                waiting.append(span)
        self._pending.extend(waiting)

    def new_frame(self) -> None:
        """A frame starts: the device spans that have run are read."""
        self._drain()

    def totals(self) -> dict[str, tuple[int, float]]:
        """scope -> (calls, total host ms), largest total first."""
        return {name: (self._counts[name], self._totals[name] * 1000.0)
                for name in sorted(self._totals, key=self._totals.get, reverse=True)}

    def device_totals(self) -> dict[str, tuple[int, float]]:
        """scope -> (frames sampled, total device ms), largest total first:
        the device spans read so far, after reading those that have run."""
        self._drain()
        return {name: (self._device_counts[name], self._device_ms[name])
                for name in sorted(self._device_ms, key=self._device_ms.get, reverse=True)}

    def report(self) -> str:
        """The host totals a scope (calls, total ms, ms a call) and, where
        any scope has device spans, their device ms a sampled frame."""
        host, device = self.totals(), self.device_totals()
        lines = [f"{'scope':<32}{'calls':>8}{'total ms':>12}{'avg ms':>10}"
                 + (f"{'device ms':>12}" if device else "")]
        for name in [*host, *(n for n in device if n not in host)]:
            count, total = host.get(name, (0, 0.0))
            row = f"{name:<32}{count:>8}{total:>12.2f}"
            row += f"{total / count:>10.2f}" if count else f"{'':>10}"
            if name in device:
                frames, ms = device[name]
                row += f"{ms / frames:>12.2f}"
            lines.append(row)
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


def _start_events(device: torch.device | None, spans: list | None):
    """(start event, end event, captured) with the start recorded on the
    current stream, or None: no CUDA device, or a captured scope with
    nowhere to put its pair."""
    if device is None or device.type != "cuda":
        return None
    captured = torch.cuda.is_current_stream_capturing()
    if captured and spans is None:
        return None
    start, end = (torch.cuda.Event(enable_timing=True, external=captured) for _ in range(2))
    start.record()
    return start, end, captured


def _nvtx(name: str):
    """An NVTX range where torch has a GPU, else nothing."""
    if torch.cuda.is_available():
        return torch.cuda.nvtx.range(name)
    return contextlib.nullcontext()


PROFILER = Profiler()
