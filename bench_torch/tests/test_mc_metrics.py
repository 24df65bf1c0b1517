"""The isosurface's per-layer readers (`pass.mc_extract_ms`,
`pass.mc_refit_ms`, `mc.walk_ms`, `mc.triangles_per_frame`,
`mc.hits_per_frame`) on synthetic device totals and counters, on a program
without the spans or the counters, and on a small CPU app of the
isosurface's cell, with the isosurface on and off: off, the program makes
none of the counters and opens none of the spans."""

import dataclasses
import importlib
import types

import pytest

from harness import cli, manifest, session
from harness.session import PROGRAM

CELL = "pt_mc_sponza_1080p.still"
METRICS = ("pass.mc_extract_ms", "pass.mc_refit_ms", "mc.walk_ms", "mc.triangles_per_frame",
           "mc.hits_per_frame")
COUNTERS = ("mc/triangles", "mc/hits")
SPANS = ("mc/walk", "pass/mc_extract", "pass/mc_refit")
TINY = {"width": 32, "height": 18, "static_config": {"num_bounces": 2, "mc_grid": 8}}
ATRIUM = {"columns": 2, "sphere_detail": 8, "clutter_count": 4, "clutter_detail": 6,
          "column_slices": 8}


def _readings():
    return cli.Readings.__new__(cli.Readings)


@pytest.fixture
def profiler(monkeypatch):
    """A stand-in for the program's PROFILER: its device totals and
    counters, as the test sets them."""
    fake = types.SimpleNamespace(device={}, counted={})
    fake.device_totals = lambda: fake.device
    fake.counters = lambda: fake.counted
    module = importlib.import_module(f"{PROGRAM}.utils.profiler")
    monkeypatch.setattr(module, "PROFILER", fake)
    return fake


def test_the_prefix_passes_read_their_device_ms_a_frame(profiler):
    # 2 calls of 4 frames: the prefix's eager pairs sample every frame.
    profiler.device = {"pass/mc_extract": (8, 12.0), "pass/mc_refit": (8, 20.0),
                       "pass/reference_pt": (2, 140.0)}
    assert manifest.load_reader("pass.mc_extract_ms")(_readings()) == pytest.approx(1.5)
    assert manifest.load_reader("pass.mc_refit_ms")(_readings()) == pytest.approx(2.5)


def test_walk_ms_reads_the_walk_spans_a_sampled_frame(profiler):
    # 2 sampled frames of the path tracer, 11 walks each.
    profiler.device = {"pass/reference_pt": (2, 140.0), "mc/walk": (22, 9.0),
                       "pass/gbuffer": (2, 20.0)}
    assert manifest.load_reader("mc.walk_ms")(_readings()) == pytest.approx(4.5)


def test_the_counters_read_a_frame(profiler):
    profiler.counted = {"mc/triangles": (8, 8 * 3_512, 3_600),
                        "mc/hits": (48, 8 * 1_400_000, 650_000), "pt/rays": (8, 80, 10)}
    r = _readings()
    assert manifest.load_reader("mc.triangles_per_frame")(r) == pytest.approx(3_512)
    assert manifest.load_reader("mc.hits_per_frame")(r) == pytest.approx(1_400_000)


def test_the_readers_read_none_without_spans_or_counts(profiler):
    profiler.device = {"pass/gbuffer": (3, 30.0)}
    profiler.counted = {"mc/triangles": (0, 0, 0), "pt/rays": (4, 40, 10)}
    for metric in METRICS:
        assert manifest.load_reader(metric)(_readings()) is None
    # Walks without a sampled path-tracing frame, hits without frames.
    profiler.device = {"mc/walk": (11, 3.0)}
    profiler.counted = {"mc/hits": (6, 600, 200)}
    assert manifest.load_reader("mc.walk_ms")(_readings()) is None
    assert manifest.load_reader("mc.hits_per_frame")(_readings()) is None


def test_a_program_without_counters_or_spans_reads_none(monkeypatch):
    """A PROFILER with neither `counters` nor `device_totals` (the program
    before them) reads None, and raises nothing."""
    module = importlib.import_module(f"{PROGRAM}.utils.profiler")
    monkeypatch.setattr(module, "PROFILER", types.SimpleNamespace())
    for metric in METRICS:
        assert manifest.load_reader(metric)(_readings()) is None


@pytest.fixture
def small_scene(monkeypatch):
    """The isosurface scene's builder at a small atrium's tessellation, the
    camera at the cell's viewpoint."""
    from rust_renderer_tpu_torch import models

    config = manifest.load_cell(CELL).config

    def program(renderer, camera):
        camera.set_position_target(config["viewpoint"], config["target"])
        models.create_atrium_standin(renderer, **ATRIUM)
        renderer.add_light(position=[2.0, 3.0, 2.0], color=[1.0, 1.0, 1.0])

    monkeypatch.setattr(models, "create_sponza_scale_mc_scene", program)


def _window(isosurface: int, units: int = 2) -> int:
    """A still run's window of `units` calls on the CPU, the isosurface on
    or off, and on to the unit its check draws; returns the frames rendered
    since the window's start, which the PROFILER's counters cover."""
    cell = manifest.load_cell(CELL)
    cell = dataclasses.replace(cell, config={**cell.config,
                                             "view": {"marching_cubes_enabled": isosurface}})
    program = session.Program(cell, 7, "cpu", TINY)
    try:
        program.warm_up()
        window = program.window(0.0, units)
        assert window.failed == 0 and window.frames == 4 * units
    finally:
        program.close()
    return window.attempted


def test_a_small_isosurface_app_counts_its_triangles_and_hits(small_scene, monkeypatch):
    profiler = importlib.import_module(f"{PROGRAM}.utils.profiler").PROFILER
    monkeypatch.setattr(profiler, "_counters", {})
    frames = _window(1)
    counted = profiler.counters()
    # One extraction a frame; one closest-hit query for the g-buffer and
    # one for each of the two bounces.
    assert counted["mc/triangles"][0] == frames and counted["mc/hits"][0] == frames * 3
    r = _readings()
    triangles = manifest.load_reader("mc.triangles_per_frame")(r)
    assert 0 < triangles < 5 * 8 ** 3
    hits = manifest.load_reader("mc.hits_per_frame")(r)
    assert 0 < hits <= 3 * 32 * 18
    # The spans are opened every frame (host scopes; no device pairs on the
    # CPU): the prefix's two passes a frame, a walk for each query of the
    # g-buffer and of the path tracer.
    totals = profiler.totals()
    assert totals["pass/mc_extract"][0] == totals["pass/mc_refit"][0] == frames
    assert totals["mc/walk"][0] >= frames * 3


def test_with_the_isosurface_off_no_counter_or_span_is_made(small_scene, monkeypatch):
    profiler = importlib.import_module(f"{PROGRAM}.utils.profiler").PROFILER
    monkeypatch.setattr(profiler, "_counters", {})
    _window(0)
    assert not set(COUNTERS) & set(profiler.counters())
    assert "pt/rays" in profiler.counters()
    assert not set(SPANS) & set(profiler.totals())
    for metric in ("mc.triangles_per_frame", "mc.hits_per_frame"):
        assert manifest.load_reader(metric)(_readings()) is None
