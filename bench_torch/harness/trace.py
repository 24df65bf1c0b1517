"""The reduction of one torch.profiler window (CPU and CUDA) to what the
per-layer readers read: the device's kernel records by name, its copies
and sets, the host's named ranges (the app's PROFILER scopes and the
harness's own), and the window itself.

The profile is read from its Chrome trace (`export_chrome_trace`), where
the device's records and the host's ranges share one clock in
microseconds."""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import tempfile

from harness import stats

WINDOW_RANGE = "bench.trace_window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """One traced window: records as (name, start_us, end_us)."""

    kernels: list
    copies: list  # memcpy and memset records
    ranges: list  # the host's user annotations
    window: tuple  # (start_us, end_us)
    frames: int

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def busy_s(self) -> float:
        """Seconds of the window in which a kernel, copy or set ran."""
        spans = [(a, b) for _, a, b in self.kernels + self.copies]
        return stats.covered(spans, *self.window) * 1e-6

    def kernel_s(self, pred) -> float:
        """Summed device seconds of the kernels whose name satisfies pred."""
        return sum(b - a for n, a, b in self.kernels if pred(n)) * 1e-6

    def count(self, pred) -> int:
        return sum(1 for n, _, _ in self.kernels if pred(n))

    def device_ops(self, top: int = 10) -> list:
        """[[name, seconds]] of the kernels, copies and sets that took the
        most device time, summed by name."""
        by: dict[str, float] = {}
        for n, a, b in self.kernels + self.copies:
            key = short_name(n)
            by[key] = by.get(key, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, scopes: set, top: int = 10) -> list:
        """[[host range, seconds]] of the longest spans of the window in
        which the device ran nothing, each named by the innermost of
        `scopes` the host was in at the gap's middle ("no scope" where it
        was in none)."""
        spans = [(a, b) for _, a, b in self.kernels + self.copies]
        holes = sorted(stats.gaps(spans, *self.window), key=lambda g: g[0] - g[1])[:top]
        named = [(r, a, b) for r, a, b in self.ranges if r in scopes]
        out = []
        for a, b in holes:
            mid = 0.5 * (a + b)
            # The innermost: the latest to start, the shortest of those.
            inside = [(ra, -rb, r) for r, ra, rb in named if ra <= mid <= rb]
            out.append([max(inside)[2] if inside else "no scope", (b - a) * 1e-6])
        return out


def short_name(name: str) -> str:
    """A kernel's name without its return type and parameter list (the
    last top-level parenthesis, where the name ends with one), at most
    160 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            c = name[i]
            if c in ")>":
                depth += 1
            elif c in "(<":
                depth -= 1
                if depth == 0 and c == "(":
                    name = name[:i]
                    break
    if name.startswith("void "):
        name = name[5:]
    return name[:160]


def base_name(name: str) -> str:
    """A kernel's identifier: its name without return type, namespace,
    template arguments or parameters."""
    s = short_name(name)
    s = s.split("<", 1)[0]
    return s.rsplit("::", 1)[-1].strip()


_GLOBAL = re.compile(r"__global__\s+(?:void\s+)?(?:__launch_bounds__\s*\([^)]*\)\s*)?"
                     r"(?:void\s+)?(\w+)\s*\(")
_TRITON = re.compile(r"@triton\.jit[^\n]*\n(?:\s*@[^\n]*\n)*\s*def\s+(\w+)")


def port_kernel_names(package_dir: str) -> set[str]:
    """The identifiers of the program's own kernels: each `__global__`
    function of a CUDA source under the package and each function that a
    Python module of the package marks `@triton.jit`."""
    names: set[str] = set()
    for path in glob.glob(os.path.join(package_dir, "**", "*.cu"), recursive=True) + \
            glob.glob(os.path.join(package_dir, "**", "*.cuh"), recursive=True):
        with open(path, encoding="utf-8", errors="replace") as f:
            names.update(_GLOBAL.findall(f.read()))
    for path in glob.glob(os.path.join(package_dir, "**", "*.py"), recursive=True):
        with open(path, encoding="utf-8", errors="replace") as f:
            names.update(_TRITON.findall(f.read()))
    return names


def from_chrome(events: list, frames: int, wall_s: float | None = None) -> Trace:
    """A Trace of the records that fall in the window: the host's
    WINDOW_RANGE range where the profile traced the CPU, else (`wall_s`,
    a device-only profile) the host's wall time of the window from the
    first device record on."""
    if wall_s is None:
        win = [e for e in events if e.get("name") == WINDOW_RANGE and e.get("ph") == "X"
               and e.get("cat") == "user_annotation"]
        if not win:
            raise ValueError(f"the trace holds no '{WINDOW_RANGE}' range")
        lo = float(win[0]["ts"])
        hi = lo + float(win[0]["dur"])
    else:
        starts = [float(e["ts"]) for e in events
                  if e.get("cat") in _DEVICE_CATS and e.get("ph") == "X"]
        lo = min(starts) if starts else 0.0
        hi = lo + wall_s * 1e6
    kernels, copies, ranges = [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if b < lo or a > hi:
            continue
        cat = e.get("cat")
        if cat == "kernel":
            kernels.append((e["name"], max(a, lo), min(b, hi)))
        elif cat in _DEVICE_CATS:
            copies.append((e["name"], max(a, lo), min(b, hi)))
        elif cat == "user_annotation" and e["name"] != WINDOW_RANGE:
            ranges.append((e["name"], a, b))
    return Trace(kernels, copies, ranges, (lo, hi), frames)


def read_profile(prof, frames: int, wall_s: float | None = None) -> Trace:
    """The Trace of a finished torch.profiler.profile, through a Chrome
    trace written to a temporary directory and removed."""
    with tempfile.TemporaryDirectory(prefix="bench_trace_") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path, encoding="utf-8") as f:
            events = json.load(f).get("traceEvents", [])
    return from_chrome(events, frames, wall_s)
