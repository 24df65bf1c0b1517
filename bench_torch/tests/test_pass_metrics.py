"""The per-pass readers (`pass.<p>_ms`, `pass.<p>_host_ms.orbit`,
`graph.passes_device_ms.orbit`) on synthetic profiler totals and synthetic
device totals, and on a program without device spans."""

import importlib

import pytest

from harness import cli, manifest, passes


def _readings(totals=None, frames=4):
    r = cli.Readings.__new__(cli.Readings)
    r.profiler_totals = totals or {}
    r.window_frames = frames
    return r


@pytest.fixture
def device(monkeypatch):
    """Sets the program's device totals the readers see."""
    totals = {}
    monkeypatch.setattr(passes, "device_totals", lambda: totals)
    return totals


@pytest.mark.parametrize("p", passes.PASSES)
def test_each_pass_reads_its_device_ms_a_sampled_frame(device, p):
    device.update({f"pass/{q}": (3, 6.0 * (i + 1)) for i, q in enumerate(passes.PASSES)})
    i = passes.PASSES.index(p)
    assert manifest.load_reader(f"pass.{p}_ms")(_readings()) == pytest.approx(2.0 * (i + 1))


@pytest.mark.parametrize("p", passes.PASSES)
def test_each_pass_reads_its_host_ms_a_window_frame(p):
    r = _readings({f"pass/{p}": (8, 20.0), "frame": (4, 900.0)}, frames=4)
    assert manifest.load_reader(f"pass.{p}_host_ms.orbit")(r) == pytest.approx(5.0)


def test_a_pass_without_samples_reads_none(device):
    device.update({"pass/gbuffer": (2, 4.0), "pass/shadow": (0, 0.0)})
    r = _readings({"pass/gbuffer": (4, 1.0)}, frames=4)
    assert manifest.load_reader("pass.shadow_ms")(r) is None
    assert manifest.load_reader("pass.ssao_ms")(r) is None
    assert manifest.load_reader("pass.ssao_host_ms.orbit")(r) is None
    assert manifest.load_reader("pass.gbuffer_host_ms.orbit")(_readings(frames=0)) is None
    assert manifest.load_reader("graph.passes_device_ms.orbit")(r) is None


def test_passes_device_ms_is_the_sum_of_the_eight(device):
    device.update({f"pass/{q}": (2, float(i + 1)) for i, q in enumerate(passes.PASSES)})
    device["pass/environment"] = (1, 100.0)  # not a pass of the frame: left out
    want = sum(manifest.load_reader(f"pass.{q}_ms")(_readings()) for q in passes.PASSES)
    assert want == pytest.approx(18.0)
    assert manifest.load_reader("graph.passes_device_ms.orbit")(_readings()) == \
        pytest.approx(want)


def test_a_program_without_device_spans_reads_none(monkeypatch):
    """A profiler with no `device_totals` (the program before the spans)
    gives {} and every device reader None, without raising."""
    profiler = importlib.import_module(f"{passes.PROGRAM}.utils.profiler")
    monkeypatch.setattr(profiler, "PROFILER", object())
    assert passes.device_totals() == {}
    assert manifest.load_reader("pass.deferred_ms")(_readings()) is None
    assert manifest.load_reader("graph.passes_device_ms.orbit")(_readings()) is None
