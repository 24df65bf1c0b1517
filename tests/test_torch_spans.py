"""The frame graph's per-pass spans (`pass/<name>`, utils/profiler.py): the
host enqueue time of every pass in `render`, the isolated prefix and the
eager loop, and, on the card, each pass's device time from its timing
events, eagerly and from the replays of a captured loop.

This file imports torch and the port only, never jax, so that its card
tests run on a GPU machine without jax:

    python -m pytest tests/test_torch_spans.py -q --noconftest -p no:cacheprovider

Tests marked `cuda` skip where torch sees no GPU.
"""

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig
from rust_renderer_tpu_torch.utils.profiler import PROFILER, Profiler


@pytest.fixture
def profiler():
    """The port's PROFILER, enabled and emptied, restored afterwards."""
    enabled = PROFILER.enabled
    PROFILER.enabled = True
    PROFILER.reset()
    yield PROFILER
    PROFILER.enabled = enabled
    PROFILER.reset()


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the device spans need an NVIDIA GPU")
    return torch.device("cuda")


def _graph(device, a=None, b=None, prefix=False) -> Graph:
    """Passes `a` (x = 2 + frame time) and `b` (present_output = x * 3),
    each also running its hook; with `prefix`, an isolated pass `p` first
    whose output `a` adds."""
    g = Graph(device=device)
    g.create_buffer("x", (4,))
    g.create_texture("present_output", 2, 2, 1)

    def pass_a(res, scene, view):
        if a is not None:
            a()
        x = torch.full((4,), 2.0, device=device) + view.time
        return {"x": x + res["y"] if prefix else x}

    def pass_b(res, scene, view):
        if b is not None:
            b()
        return {"present_output": (res["x"] * 3.0)[:4].reshape(2, 2)}

    g.new_frame()
    g.clear()
    if prefix:
        g.create_buffer("y", (4,))
        g.add_pass("p").write("y").render(
            lambda res, scene, view: {"y": torch.ones(4, device=device)}).isolate().build()
    builder = g.add_pass("a").write("x")
    if prefix:
        builder.read("y")
    builder.render(pass_a).build()
    g.add_pass("b").read("x").write("present_output").render(pass_b).build()
    return g


def _calls(prof) -> dict:
    return {name: calls for name, (calls, _) in prof.totals().items()}


# -- host spans, on the CPU ----------------------------------------------------------


def test_render_spans_each_pass_inside_render(profiler):
    """`render` opens `pass/a` and `pass/b` once a frame; their host time is
    part of the enclosing `render` scope's, and in a torch.profiler trace
    their ranges lie inside the `render` range."""
    g = _graph("cpu")
    for _ in range(3):
        with profiler.scope("render"):
            g.render(None, RenderSettings.default())
    assert _calls(profiler) == {"render": 3, "pass/a": 3, "pass/b": 3}
    totals = profiler.totals()
    assert totals["pass/a"][1] + totals["pass/b"][1] <= totals["render"][1]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with profiler.scope("render"):
            g.render(None, RenderSettings.default())
    ranges = {e.name: e.time_range for e in p.events()
              if e.name in ("render", "pass/a", "pass/b")}
    assert set(ranges) == {"render", "pass/a", "pass/b"}
    render = ranges["render"]
    for name in ("pass/a", "pass/b"):
        assert render.start <= ranges[name].start <= ranges[name].end <= render.end
    assert ranges["pass/a"].end <= ranges["pass/b"].start


@pytest.mark.parametrize("prefix", [False, True])
def test_eager_loop_spans_each_pass_once_a_frame(profiler, prefix):
    """The eager `render_loop` (the CPU's) opens each pass's span once a
    frame, the isolated prefix's too."""
    g = _graph("cpu", prefix=prefix)
    g.render_loop(None, RenderSettings.default(), 3)
    assert g.last_loop_form.startswith("eager")
    want = {"pass/a": 3, "pass/b": 3, **({"pass/p": 3} if prefix else {})}
    assert _calls(profiler) == want


def test_no_device_spans_on_the_cpu_or_when_disabled(profiler):
    """On CPU tensors a pass span makes no event; a disabled profiler times
    nothing and makes none, whatever the device."""
    g = _graph("cpu")
    g.render(None, RenderSettings.default())
    g.render_loop(None, RenderSettings.default(), 2)
    profiler.new_frame()
    assert _calls(profiler) == {"pass/a": 3, "pass/b": 3}
    assert profiler.device_totals() == {}
    profiler.reset()
    profiler.enabled = False
    g.render(None, RenderSettings.default())
    with profiler.scope("pass/cuda", device=torch.device("cuda")):
        pass
    assert profiler.totals() == {} and profiler.device_totals() == {}


def test_a_pass_failing_after_a_reload_is_timed_under_its_own_name(profiler, caplog):
    """A pass that raises after a reload runs its last good function inside
    its own span: one `pass/a` a frame, and no other name."""
    g = _graph("cpu")
    g.render(None, RenderSettings.default())
    g.recompile()

    def broken(res, scene, view):
        raise RuntimeError("bad")

    g.passes[0].fn = broken
    out = g.render(None, RenderSettings.default())["present_output"]
    assert out.flatten().tolist() == [6.0] * 4
    assert any("failed after a hot reload" in r.getMessage() for r in caplog.records)
    assert _calls(profiler) == {"pass/a": 2, "pass/b": 2}


class _Event:
    """A stand-in for a CUDA timing event: done or not, at a time (ms)."""

    def __init__(self, ms, done=True):
        self.ms, self.done = ms, done

    def query(self):
        return self.done

    def elapsed_time(self, end):
        assert self.done and end.done
        return end.ms - self.ms


def test_device_spans_are_read_once_they_have_run():
    """Queued event pairs are read when their end has run (at `new_frame`
    and `device_totals`), the others kept for later; a pair queued again
    while still waiting counts once; `report` adds a device column, with a
    row for a span that has device time and no host call."""
    prof = Profiler()
    with prof.scope("pass/a"):
        pass
    late = _Event(7.5, done=False)
    a = ("pass/a", _Event(1.0), _Event(3.0))
    b = ("pass/b", _Event(3.0), late)
    prof.queue([a, b])
    prof.queue([a, b])
    prof.new_frame()
    assert prof.device_totals() == {"pass/a": (1, 2.0)}
    late.done = True
    prof.queue([a])
    assert prof.device_totals() == {"pass/b": (1, 4.5), "pass/a": (2, 4.0)}
    lines = prof.report().splitlines()
    assert lines[0].endswith("device ms")
    assert lines[1].startswith("pass/a") and lines[1].endswith("2.00")
    assert lines[2].split() == ["pass/b", "0", "0.00", "4.50"]
    prof.reset()
    assert prof.device_totals() == {} and "device" not in prof.report()


# -- device spans, on the card ---------------------------------------------------------


def _timed(fn) -> float:
    """The device ms of what fn() enqueues, the median of 5 event pairs."""
    times = []
    for _ in range(5):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[2]


def _sleepers():
    """Hooks that keep the card busy for about 2 ms and 1 ms
    (torch.cuda._sleep at the clock rate measured after a warm-up)."""
    for _ in range(20):
        torch.cuda._sleep(2_000_000)
    cycles_per_ms = 2_000_000 / _timed(lambda: torch.cuda._sleep(2_000_000))
    return tuple((lambda c=int(cycles_per_ms * ms): torch.cuda._sleep(c)) for ms in (2.0, 1.0))


def _assert_spans_read_the_hooks(prof, hooks, frames):
    """Each pass's spans: `frames` samples, averaging its hook's device
    time (timed alone, now) within 10%."""
    totals = prof.device_totals()
    assert {n: f for n, (f, _) in totals.items()} == {"pass/a": frames, "pass/b": frames}
    for name, hook in zip(("pass/a", "pass/b"), hooks):
        want = _timed(hook)
        got = totals[name][1] / frames
        assert got == pytest.approx(want, rel=0.1), (name, got, want)


@pytest.mark.cuda
def test_eager_pass_spans_read_device_time_on_card(cuda_device, profiler):
    """`render` on the card: each pass's device time, ~2 ms and ~1 ms of
    sleep, read from its events within 10%, one sample a frame."""
    hooks = _sleepers()
    g = _graph(cuda_device, *hooks)
    g.render(None, RenderSettings.default())
    torch.cuda.synchronize()
    profiler.reset()
    for _ in range(4):
        profiler.new_frame()
        g.render(None, RenderSettings.default())
    torch.cuda.synchronize()
    _assert_spans_read_the_hooks(profiler, hooks, 4)


@pytest.mark.cuda
def test_captured_loop_reads_pass_spans_from_its_replays_on_card(cuda_device, profiler):
    """`render_loop(4)` captured: each call adds one sample a pass, the last
    replayed frame's (read at the next frame start once the image has
    reached the host), within 10% of the sleep; toggling the profiler
    captures anew (off: no event in the capture, no device sample), and the
    image is the same bit for bit with the spans on and off."""
    hooks = _sleepers()
    g = _graph(cuda_device, *hooks)
    view = RenderSettings.default()
    want = g.render_loop(None, view, 4)
    assert g.last_loop_form == "captured" and g.captures == 1
    torch.cuda.synchronize()
    profiler.reset()
    for _ in range(3):
        got = g.render_loop(None, view, 4)
        torch.cuda.synchronize()  # as the app's present waits for the image
        profiler.new_frame()
    assert g.captures == 1
    assert _calls(profiler) == {}  # a replay opens no host span
    _assert_spans_read_the_hooks(profiler, hooks, 3)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

    profiler.reset()
    profiler.enabled = False
    off = g.render_loop(None, view, 4)
    assert g.captures == 2 and not g._loop.spans
    off = g.render_loop(None, view, 4)
    torch.cuda.synchronize()
    assert profiler.device_totals() == {}
    torch.testing.assert_close(off, want, rtol=0, atol=0)
    profiler.enabled = True
    g.render_loop(None, view, 4)
    assert g.captures == 3 and len(g._loop.spans) == 2


@pytest.mark.cuda
def test_raster_frames_are_the_same_with_spans_on_and_off_on_card(cuda_device, profiler):
    """The 64² RASTERIZED app's host frame and captured `run_on_device(3)`
    present the same image bit for bit with the profiler on and off."""
    cfg = StaticConfig(shadow_map_size=128, cubemap_size=16, cubemap_mips=4,
                       irradiance_size=8, brdf_lut_size=16, mc_grid=8)
    images = {}
    for enabled in (True, False):
        profiler.reset()
        profiler.enabled = enabled
        app = Application(64, 64, RenderGraphMode.RASTERIZED, cfg=cfg, device=cuda_device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        images[enabled] = (app.run(1), app.run_on_device(3, tstep=0.0).cpu().numpy())
        assert app.graph.last_loop_form == "captured"
        spans = {f"pass/{p.name}" for p in app.graph.passes}
        assert (spans <= set(profiler.device_totals())) == enabled
    for on, off in zip(images[True], images[False]):
        np.testing.assert_array_equal(on, off)


# -- the shadow pass's spans and its rows counter --------------------------------

SHADOW_CFG = dict(shadow_map_size=256, cubemap_size=16, cubemap_mips=4, irradiance_size=8,
                  brdf_lut_size=16)


def _shadow_app(device, method="binned", width=48, height=32):
    """A RASTERIZED app of the cube scene with its cascades on, the clock
    pinned."""
    cfg = StaticConfig(**SHADOW_CFG, raster_method=method)
    app = Application(width, height, RenderGraphMode.RASTERIZED, cfg=cfg, device=device)
    app.fps_timer.elapsed_seconds = lambda: 0.25
    app.create_scene()
    return app


def _binned_rows(app) -> tuple[int, int]:
    """A frame's binned rows over the app's cascades, each cascade's
    segments and global list (`bins.counts.sum() + g_count`), and the
    largest tile's rows (its segment and the global list), from the bins
    made anew."""
    from rust_renderer_tpu_torch.ops import raster, raster_binned

    shadow_pass = next(p for p in app.graph.passes if p.name == "shadow")
    size = app.cfg.shadow_map_size
    total, peak = 0, 0
    for vp in shadow_pass.uniforms["cascade_vp"]:
        clip = raster.transform_vertices(app.scene.positions, vp.to(app.device))
        bins = raster_binned.depth_bins(clip, app.scene.indices, size, size)
        total += int(bins.counts.sum()) + int(bins.g_count)
        peak = max(peak, int(bins.counts.max()) + int(bins.g_count))
    return total, peak


def test_shadow_pass_counts_its_binned_rows_and_spans_each_cascade(profiler):
    """On the binned path (K4's plain version on the CPU) a frame adds its
    cascades' binned rows to the counter `shadow/rows` and raises its peak
    to the largest tile's rows; `shadow/bin` and `shadow/raster` are opened
    once a cascade, inside `pass/shadow`; the eager loop counts every frame
    too. A reset zeroes the counter in place."""
    app = _shadow_app("cpu")
    app.run(1)
    total, peak = _binned_rows(app)
    assert total > 0 and peak > 0
    profiler.reset()
    app.run(2)
    assert profiler.counters()["shadow/rows"] == (2, 2 * total, peak)
    calls = _calls(profiler)
    assert calls["pass/shadow"] == 2 and calls["shadow/bin"] == calls["shadow/raster"] == 8
    totals = profiler.totals()
    assert totals["shadow/bin"][1] + totals["shadow/raster"][1] <= totals["pass/shadow"][1]
    counter = profiler._counters["shadow/rows"]
    profiler.reset()
    assert profiler._counters["shadow/rows"] is counter
    assert profiler.counters()["shadow/rows"] == (0, 0, 0)
    app.run_on_device(3, tstep=0.0)
    assert app.graph.last_loop_form.startswith("eager")
    assert profiler.counters()["shadow/rows"] == (3, 3 * total, peak)


def test_shadow_pass_counts_nothing_on_the_brute_path_or_disabled(profiler):
    """The brute path bins nothing: its cascades are spanned but not
    counted. A disabled profiler counts nothing."""
    app = _shadow_app("cpu", method="brute")
    app.run(1)
    assert profiler.counters().get("shadow/rows", (0, 0, 0)) == (0, 0, 0)
    assert _calls(profiler)["shadow/raster"] == 4
    app = _shadow_app("cpu")
    profiler.reset()
    profiler.enabled = False
    app.run(1)
    assert profiler.counters().get("shadow/rows", (0, 0, 0)) == (0, 0, 0)
    assert profiler.totals() == {}


@pytest.mark.cuda
def test_captured_shadow_pass_counts_every_replay_on_card(cuda_device, profiler):
    """`run_on_device(4)` captured: the counter counts 4 frames a call (the
    first call's eager frame and 3 replays, then 4 replays), each frame's
    rows those of the bins made anew; each replayed frame's device spans
    `shadow/bin` and `shadow/raster`, 4 each, lie inside its `pass/shadow`."""
    app = _shadow_app(cuda_device, method="auto", width=128, height=64)
    app.run(1)
    total, peak = _binned_rows(app)
    torch.cuda.synchronize()
    profiler.reset()
    app.run_on_device(4, tstep=0.0)
    assert app.graph.last_loop_form == "captured"
    assert profiler.counters()["shadow/rows"] == (4, 4 * total, peak)
    torch.cuda.synchronize()
    profiler.reset()
    for _ in range(2):
        app.run_on_device(4, tstep=0.0)
        torch.cuda.synchronize()
        profiler.new_frame()
    assert app.graph.captures == 1
    assert profiler.counters()["shadow/rows"] == (8, 8 * total, peak)
    device = profiler.device_totals()
    assert device["pass/shadow"][0] == 2
    assert device["shadow/bin"][0] == device["shadow/raster"][0] == 8
    assert device["shadow/bin"][1] + device["shadow/raster"][1] <= device["pass/shadow"][1]
