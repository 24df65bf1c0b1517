"""The program under test (``rust_renderer_tpu_torch``): its set-up, the
measured window and the traced window, as a traffic mix drives them.

The app is the program's `Application`, built as the configuration says,
with the seeded clock in place of its FpsTimer. A unit is what the loop
repeats: one frame of the host loop (input, `render_frame`, `present`), or
one call of the device loop (`run_on_device(n)`, `present`). The units the
check recomputes are drawn from the seed; before and after each, the
frame's persistent state is copied on the device."""

from __future__ import annotations

import dataclasses
import importlib
import time
import traceback

import numpy as np
import torch

from harness import rays, trace, traffic

PROGRAM = "rust_renderer_tpu_torch"


def build_app(package: str, config: dict, device, size: dict | None = None):
    """An `Application` of `package` (the program under test) as
    `config` says, its scene created. `size` overrides the width, height
    and StaticConfig fields (the tests' tiny sizes)."""
    main = importlib.import_module(f"{package}.app.main")
    settings = importlib.import_module(f"{package}.settings")
    models = importlib.import_module(f"{package}.models")
    size = size or {}
    static = {**config.get("static_config", {}), **size.get("static_config", {})}
    app = main.Application(size.get("width", config["width"]),
                           size.get("height", config["height"]),
                           settings.RenderGraphMode[config["mode"]],
                           settings.StaticConfig(**static), device=device)
    app.view = app.view.replace(**{k: np.int32(v) for k, v in config.get("view", {}).items()})
    app.create_scene(getattr(models, config["builder"]))
    return app


def check_units(seed: int, traffic_doc: dict) -> list[int]:
    """The window's units (0-based) that the check recomputes, drawn from
    the seed: `checks` distinct units in the range `check_units`."""
    lo, hi = traffic_doc["check_units"]
    rng = traffic.seed_rng(seed, "check")
    picks = rng.choice(np.arange(lo, hi + 1), size=traffic_doc["checks"], replace=False)
    return sorted(int(u) for u in picks)


def frame_state(graph) -> dict:
    """Copies of the persistent resources the frame's passes write (the
    accumulation, the reservoirs, the ray count); the environment maps,
    which the reference makes itself, are not among them."""
    written = {w for p in graph.passes for w in p.writes}
    return {n: graph.state[n].clone() for n in sorted(graph.persist & written)
            if n in graph.state}


@dataclasses.dataclass
class Checked:
    """One recomputed unit: the state before and after it, and its image."""

    unit: int
    before: dict
    after: dict
    image: np.ndarray


@dataclasses.dataclass
class Window:
    frames: int
    seconds: float
    latencies: list  # seconds, one per unit of the host loop
    checked: list
    attempted: int
    failed: int
    error: str | None


class Program:
    """The program's app as one cell drives it."""

    def __init__(self, cell, seed: int, device="cuda", size: dict | None = None,
                 count_rays: bool = False):
        self.device = torch.device(device)
        self.cell, self.seed = cell, seed
        # The ray counter adds its own kernels to every traversal call (and
        # to a captured loop), so only a traced run installs it, before the
        # warm-up captures the loop.
        self.counter = (rays.RayCounter(importlib.import_module(f"{PROGRAM}.ops.traversal"),
                                        self.device) if count_rays else None)
        self.profiler = importlib.import_module(f"{PROGRAM}.utils.profiler").PROFILER
        self.app = build_app(PROGRAM, cell.config, self.device, size)
        self.clock = traffic.clock_for(seed, cell.traffic)
        self.app.fps_timer = self.clock
        t = cell.traffic
        self.host_loop = t["loop"] == "host"
        self.per_unit = traffic.frames_per_unit(t)
        self.path = (traffic.orbit_inputs(t, cell.config["viewpoint"], cell.config["target"])
                     if self.host_loop else None)
        self.mouse = [0.0, 0.0]
        self.bad = torch.zeros((), dtype=torch.int64, device=self.device)

    def unit(self, warm_up: bool = False):
        """One unit; returns its presented image (numpy)."""
        app = self.app
        if self.host_loop:
            app.input.begin_frame()
            if not warm_up:
                traffic.apply_input(app.input, next(self.path), self.mouse)
            img = app.render_frame()["present_output"]
        else:
            img = app.run_on_device(self.per_unit, tstep=self.clock.step)
        self.bad.add_(torch.isfinite(img).logical_not().any().to(torch.int64))
        out = app.present(img)
        self.clock.advance(self.per_unit)
        return out

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warm_up(self) -> None:
        """The warm-up unit: every kernel this cell's frames launch is built
        and loaded, the environment captured where the mode reads it, and
        the device loop captured.

        Refuses a device-loop mix whose graph the device loop cannot run:
        `run_on_device` would render its frames through the host loop, all
        at the unit's first time (the seeded clock advances a unit at a
        time), and no reference could follow them by `check.Unit.time`."""
        self.unit(warm_up=True)
        self.sync()
        if not self.host_loop:
            reason = self.app.graph.device_loop_unsupported_reason()
            if reason is not None:
                raise RuntimeError(f"the device loop falls back to the host loop ({reason}): "
                                   "its frames would not follow the seeded clock")

    def window(self, seconds: float, units: int | None = None) -> Window:
        """Units until `seconds` have passed (or, for tests, `units` units),
        then on to the last unit the check recomputes if the window closed
        before it. The window's time ends with the last image on the host."""
        todo = check_units(self.seed, self.cell.traffic)
        self.bad.zero_()
        self.profiler.reset()
        checked, lat = [], []
        done = attempted = failed = 0
        error = None
        t0 = time.perf_counter()
        t_end = t0
        while True:
            in_window = (done < units) if units is not None else \
                (time.perf_counter() - t0 < seconds)
            if not in_window and (not todo or done > todo[-1]):
                break
            keep = done in todo
            before = frame_state(self.app.graph) if keep else None
            ts = time.perf_counter()
            attempted += self.per_unit
            try:
                img = self.unit()
            except Exception:  # a frame that raises has failed; the run stops
                error = traceback.format_exc()
                failed += self.per_unit
                break
            te = time.perf_counter()
            if in_window:
                lat.append(te - ts)
                t_end = te
            if keep:
                checked.append(Checked(done, before, frame_state(self.app.graph), img))
            done += 1
        failed += int(self.bad) * self.per_unit
        return Window(frames=len(lat) * self.per_unit, seconds=t_end - t0,
                      latencies=lat, checked=checked, attempted=attempted,
                      failed=failed, error=error)

    def traced(self, units: int) -> tuple:
        """`units` more units under torch.profiler tracing the device only,
        so the host runs at nearly its own pace: their Trace (its window
        the host's wall time) and the ray counts (closest, any-hit) of
        those units (None without the counter). Then one unit more traced on the CPU too, whose Trace
        names the idle gaps by the host's ranges."""
        prof = torch.profiler
        self.sync()
        if self.counter is not None:
            self.counter.reset()
        cuda = [prof.ProfilerActivity.CUDA] if self.device.type == "cuda" else []
        with prof.profile(activities=cuda or [prof.ProfilerActivity.CPU]) as p:
            t0 = time.perf_counter()
            for _ in range(units):
                self.unit()
            self.sync()
            wall = time.perf_counter() - t0
        counts = self.counter.read() if self.counter is not None else None
        measured = trace.read_profile(p, units * self.per_unit, wall)
        with prof.profile(activities=[prof.ProfilerActivity.CPU, *cuda]) as p:
            with prof.record_function(trace.WINDOW_RANGE):
                self.unit()
                self.sync()
        named = trace.read_profile(p, self.per_unit)
        return measured, named, counts

    def close(self) -> None:
        """Free the program's state (its app, its captured loop)."""
        if self.counter is not None:
            self.counter.remove()
        self.app = None
        self.path = None
