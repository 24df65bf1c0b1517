"""The path-traced frame's per-layer readers (`pass.initial_ris_ms`,
`pass.temporal_reuse_ms`, `pass.spatial_reuse_ms`, `pass.reference_pt_ms`,
`pt.rays_per_frame`, `pt.front_max`, `pt.ended_per_frame`) on synthetic
device totals and counters, on the program's own PROFILER, and on a program
without the spans or the counters."""

import importlib
import types

import pytest
import torch

from harness import cli, manifest
from harness.session import PROGRAM

PASSES = ("initial_ris", "temporal_reuse", "spatial_reuse", "reference_pt")
COUNTED = ("pt.rays_per_frame", "pt.front_max", "pt.ended_per_frame")


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


@pytest.mark.parametrize("p", PASSES)
def test_each_pt_pass_reads_its_device_ms_a_sampled_frame(profiler, p):
    profiler.device = {f"pass/{q}": (4, 8.0 * (i + 1)) for i, q in enumerate(PASSES)}
    want = 2.0 * (PASSES.index(p) + 1)
    assert manifest.load_reader(f"pass.{p}_ms")(_readings()) == pytest.approx(want)


def test_the_counters_read_a_frame_and_the_largest_front(profiler):
    profiler.counted = {"pt/rays": (8, 8 * 17_777_111, 3_775_472), "pt/ended": (8, 3, 2),
                        "shadow/rows": (1, 5, 5)}
    r = _readings()
    assert manifest.load_reader("pt.rays_per_frame")(r) == pytest.approx(17_777_111)
    assert manifest.load_reader("pt.front_max")(r) == 3_775_472
    assert manifest.load_reader("pt.ended_per_frame")(r) == pytest.approx(3 / 8)


def test_no_lane_ended_reads_zero(profiler):
    profiler.counted = {"pt/rays": (4, 400, 120), "pt/ended": (4, 0, 0)}
    assert manifest.load_reader("pt.ended_per_frame")(_readings()) == 0.0


def test_the_readers_read_none_without_spans_or_counts(profiler):
    profiler.device = {"pass/gbuffer": (3, 30.0)}
    profiler.counted = {"pt/rays": (0, 0, 0)}
    for metric in [f"pass.{p}_ms" for p in PASSES] + list(COUNTED):
        assert manifest.load_reader(metric)(_readings()) is None


def test_a_program_without_counters_or_spans_reads_none(monkeypatch):
    """A PROFILER with neither `counters` nor `device_totals` (the program
    before them) reads None, and raises nothing."""
    module = importlib.import_module(f"{PROGRAM}.utils.profiler")
    monkeypatch.setattr(module, "PROFILER", types.SimpleNamespace())
    for metric in [f"pass.{p}_ms" for p in PASSES] + list(COUNTED):
        assert manifest.load_reader(metric)(_readings()) is None


def test_the_readers_read_the_programs_own_counters():
    profiler = importlib.import_module(f"{PROGRAM}.utils.profiler").PROFILER
    profiler.reset()
    try:
        for rays, front, ended in ((1000, 300, 0), (3000, 500, 2)):
            profiler.count("pt/rays", torch.tensor(rays), torch.tensor(front))
            profiler.count("pt/ended", torch.tensor(ended), torch.tensor(ended))
        r = _readings()
        assert manifest.load_reader("pt.rays_per_frame")(r) == pytest.approx(2000)
        assert manifest.load_reader("pt.front_max")(r) == 500
        assert manifest.load_reader("pt.ended_per_frame")(r) == pytest.approx(1.0)
    finally:
        profiler.reset()
