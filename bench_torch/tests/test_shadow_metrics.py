"""The shadow pass's per-layer readers (`shadow.bin_ms`,
`shadow.rows_per_frame`, `shadow.tile_rows_max`) on synthetic device totals
and counters, on the program's own PROFILER, and on a program without the
spans or the counter."""

import importlib
import types

import pytest
import torch

from harness import cli, counters, manifest, passes
from harness.session import PROGRAM

METRICS = ("shadow.bin_ms", "shadow.rows_per_frame", "shadow.tile_rows_max")


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


def test_bin_ms_reads_the_bin_spans_a_sampled_frame(profiler):
    # 3 sampled frames of the shadow pass, 4 bin spans each.
    profiler.device = {"pass/shadow": (3, 30.0), "shadow/bin": (12, 21.0),
                       "shadow/raster": (12, 6.0)}
    assert manifest.load_reader("shadow.bin_ms")(_readings()) == pytest.approx(7.0)


def test_rows_read_the_counter_a_frame_and_its_peak(profiler):
    profiler.counted = {"shadow/rows": (8, 8 * 1_234_567, 40_000), "other": (1, 5, 5)}
    r = _readings()
    assert manifest.load_reader("shadow.rows_per_frame")(r) == pytest.approx(1_234_567)
    assert manifest.load_reader("shadow.tile_rows_max")(r) == 40_000


def test_the_readers_read_none_without_spans_or_counts(profiler):
    profiler.device = {"pass/shadow": (3, 30.0)}
    profiler.counted = {"shadow/rows": (0, 0, 0)}
    for metric in METRICS:
        assert manifest.load_reader(metric)(_readings()) is None


def test_a_program_without_counters_or_spans_reads_none(monkeypatch):
    """A PROFILER with neither `counters` nor `device_totals` (the program
    before them) reads None, and raises nothing."""
    module = importlib.import_module(f"{PROGRAM}.utils.profiler")
    monkeypatch.setattr(module, "PROFILER", types.SimpleNamespace())
    assert passes.device_totals() == {} and counters.counter("shadow/rows") is None
    for metric in METRICS:
        assert manifest.load_reader(metric)(_readings()) is None


def test_the_readers_read_the_programs_own_counter():
    profiler = importlib.import_module(f"{PROGRAM}.utils.profiler").PROFILER
    profiler.reset()
    try:
        profiler.count("shadow/rows", torch.tensor(100), torch.tensor(7, dtype=torch.int32))
        profiler.count("shadow/rows", torch.tensor(300), torch.tensor(5, dtype=torch.int32))
        assert manifest.load_reader("shadow.rows_per_frame")(_readings()) == pytest.approx(200)
        assert manifest.load_reader("shadow.tile_rows_max")(_readings()) == 7
    finally:
        profiler.reset()
