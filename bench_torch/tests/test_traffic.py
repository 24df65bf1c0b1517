"""The seeded clock and the host loop's camera path."""

import itertools
import json
import os

import numpy as np

from harness import manifest, traffic


def _orbit():
    with open(os.path.join(manifest.BENCH_DIR, "traffic", "orbit.json")) as f:
        return json.load(f)


def _path(doc, n, path_seed=None):
    if path_seed is not None:
        doc = {**doc, "input": {**doc["input"], "path_seed": path_seed}}
    return list(itertools.islice(
        traffic.orbit_inputs(doc, [-10.28, 2.10, -0.18], [0.0, 0.5, 0.0]), n))


def test_clock_is_the_same_for_one_seed_and_differs_for_two():
    doc = _orbit()
    a, b = traffic.clock_for(2 ** 33 + 7, doc), traffic.clock_for(2 ** 33 + 7, doc)
    c = traffic.clock_for(2 ** 33 + 8, doc)
    for clock in (a, b, c):
        clock.advance(5)
    assert a.elapsed_seconds() == b.elapsed_seconds() != c.elapsed_seconds()
    a.advance(1)
    assert np.isclose(a.elapsed_seconds() - b.elapsed_seconds(), 1.0 / 60.0)
    assert 0.0 <= a.t0 <= 600.0


def test_path_is_the_same_for_one_path_seed_and_differs_for_two():
    doc = _orbit()
    first = _path(doc, 300)
    assert first == _path(doc, 300)
    # A shorter run takes the first frames of the same path.
    assert _path(doc, 40) == first[:40]
    assert _path(doc, 300, path_seed=12345) != first


def test_path_follows_its_parameters():
    doc = _orbit()
    p = doc["input"]
    path = _path(doc, 2000)
    yaw = np.array([f.yaw_px for f in path])
    assert np.all((np.abs(yaw) >= p["yaw_px"][0]) & (np.abs(yaw) <= p["yaw_px"][1]))
    pitch = np.array([f.pitch_px for f in path])
    assert np.all((pitch >= p["pitch_px"][0]) & (pitch <= p["pitch_px"][1]))
    # Sign runs of the yaw last 20-60 frames (the last may be cut).
    runs = [len(list(g)) for _, g in itertools.groupby(np.sign(yaw))]
    assert min(runs[:-1]) >= p["yaw_flip_frames"][0]
    assert max(runs) <= p["yaw_flip_frames"][1]
    keys = [f.key for f in path]
    assert set(keys) <= {None, "w", "a", "s", "d"}
    assert 0.1 < keys.count(None) / len(keys) < 0.6


def test_check_units_are_drawn_from_the_seed():
    from harness import session

    doc = _orbit()
    a = session.check_units(2 ** 31 + 11, doc)
    assert a == session.check_units(2 ** 31 + 11, doc)
    assert len(a) == doc["checks"] and len(set(a)) == len(a)
    assert all(doc["check_units"][0] <= u <= doc["check_units"][1] for u in a)
    draws = {tuple(session.check_units(s, doc)) for s in range(20)}
    assert len(draws) > 1
