"""The check's replay hands the reference each unit's seeded clock and frame
count as the program ran them, in both loops, on the CPU at a tiny size.

The configuration is a path-traced frame on a small scene, declared here:
the path-traced frame seeds every random stream from `view.time`, so its
reference needs each frame's time. The reference is `clock_probe`, which
records the units it is handed; the program's frames are recorded by
wrapping its view update (`Application._refresh_view` in the host loop,
`app.main._loop_view_update` in the device loop)."""

import dataclasses

import clock_probe
import pytest
import torch

from harness import cli, manifest, session

from test_check import TINY

PT = {"builder": "create_cube_scene", "mode": "PATH_TRACED", "width": 1920, "height": 1080,
      "static_config": {"num_bounces": 2}, "view": {},
      "viewpoint": [-2.5, 3.0, -2.5], "target": [10.0, 1.0, 10.0],
      "reference": "clock_probe"}
SEED = 2 ** 32 + 29
MIXES = {"orbit": "raster_rtshadows_sponza_1080p.orbit",
         "still": "raster_rtshadows_sponza_1080p.still"}


def _run(monkeypatch, mix: str, extra_frames: int = 0):
    """One run of the PT configuration under `mix` (units up to the last
    one the check may draw): the units the probe was handed, the units it
    rendered, and the program's frame times, a list a unit (the warm-up
    first). `extra_frames`: a fault, the program's clock advanced that
    many frames more after each unit."""
    from rust_renderer_tpu_torch.app import main

    cell = dataclasses.replace(manifest.load_cell(MIXES[mix]), config=PT, limits={})
    monkeypatch.setattr(clock_probe, "UNITS", [])
    monkeypatch.setattr(clock_probe, "RENDERED", [])
    drawn: list = []
    unit, refresh, update = session.Program.unit, main.Application._refresh_view, \
        main._loop_view_update

    def program_unit(self, warm_up=False):
        drawn.append([])
        out = unit(self, warm_up)
        self.clock.advance(extra_frames)
        return out

    def refresh_view(self):
        refresh(self)
        if mix == "orbit":
            drawn[-1].append(float(self.view.time))

    def loop_view_update(view, k, aux):
        out = update(view, k, aux)
        drawn[-1].append(float(out.time))
        return out

    monkeypatch.setattr(session.Program, "unit", program_unit)
    monkeypatch.setattr(main.Application, "_refresh_view", refresh_view)
    monkeypatch.setattr(main, "_loop_view_update", loop_view_update)
    units = max(cell.traffic["check_units"]) + 1
    with torch.no_grad():
        res = cli.run(cell, SEED, 0.0, False, "cpu", size=TINY, units=units)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    return cell, clock_probe.UNITS, clock_probe.RENDERED, drawn


def _mismatches(handed: list, drawn: list) -> list:
    """Where the units the reference was handed differ from the program's:
    each handed unit against the program's unit of that index, by its
    frame count and each frame's time."""
    out = []
    for u in handed:
        times = drawn[u.index + 1]
        if u.frames != len(times):
            out.append((u.index, "frames", u.frames, len(times)))
        for k, t in enumerate(times):
            if float(u.time(k)) != t:
                out.append((u.index, k, float(u.time(k)), t))
    return out


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_the_reference_is_handed_each_units_clock_and_frames(monkeypatch, mix):
    cell, handed, rendered, drawn = _run(monkeypatch, mix)
    checked = session.check_units(SEED, cell.traffic)
    assert rendered == checked
    assert [u.index for u in handed] == list(range(-1, checked[-1] + 1))
    assert {u.frames for u in handed} == {1 if mix == "orbit" else 4}
    assert _mismatches(handed, drawn) == []
    # The clock moves: no two frames of the replay share a time.
    times = [u.time(k) for u in handed for k in range(u.frames)]
    assert len(set(times)) == len(times)


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_program_clock_one_frame_ahead_is_caught(monkeypatch, mix):
    _, handed, _, drawn = _run(monkeypatch, mix, extra_frames=1)
    bad = _mismatches(handed, drawn)
    # The warm-up matches; every later unit starts index + 1 frames late.
    assert {m[0] for m in bad} == {u.index for u in handed if u.index >= 0}


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_a_device_loop_that_falls_back_to_the_host_loop_is_refused(monkeypatch, mix):
    """Where the device loop would render a call through the host loop, the
    call's frames all read its first time, not `Unit.time(k)`: the still mix
    refuses the run at the warm-up. The orbit mix never asks for the device
    loop, and runs as before."""
    from rust_renderer_tpu_torch.graph import Graph

    monkeypatch.setattr(Graph, "device_loop_unsupported_reason", lambda self: "a test's reason")
    if mix == "still":
        with pytest.raises(RuntimeError, match="falls back to the host loop"):
            _run(monkeypatch, mix)
    else:
        _, handed, _, drawn = _run(monkeypatch, mix)
        assert _mismatches(handed, drawn) == []
