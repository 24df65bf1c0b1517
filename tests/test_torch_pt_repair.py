"""The path tracer ends a lane whose scattered direction is zero or not
finite, and counts the rays and the ended lanes on the device.

Without the rule such a lane went on as a miss, and the sky of a zero
direction is NaN, which the accumulation then carried. Here a `scatter`
that gives one pixel a zero direction and another a NaN direction at the
first bounce of the second frame stands in for a metal or dielectric hit
that does so; everything else is the PT frame on the CPU on the cube
scene."""

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch import models
from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.ops import materials
from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig
from rust_renderer_tpu_torch.utils.profiler import PROFILER

W, H = 24, 16
# (row, column): primary rays that hit the floor, below the horizon.
ZERO, NAN = (12, 5), (14, 17)


class _Clock:
    """A clock that stands still: view.time seeds every random stream."""

    fps = 0.0

    def elapsed_seconds(self) -> float:
        return 12.5

    def calculate(self) -> None:
        pass


def _app():
    app = Application(W, H, RenderGraphMode.PATH_TRACED, StaticConfig(num_bounces=2),
                      device="cpu")
    app.create_scene(models.create_cube_scene)
    app.fps_timer = _Clock()
    return app


def _frames(monkeypatch, plant: bool):
    """Two frames; with `plant`, the second frame's first scatter gives
    ZERO a zero direction and NAN a NaN one. Returns the accumulation after
    each frame, the second frame's image and its counters."""
    scatter = materials.scatter
    calls = []

    def planted(*args, **kwargs):
        state, sc = scatter(*args, **kwargs)
        calls.append(1)
        if plant and len(calls) == 3:  # frame 2, bounce 1 of 2
            d = sc.direction.clone()
            d[ZERO] = 0.0
            d[NAN] = float("nan")
            sc = sc._replace(direction=d)
        return state, sc

    monkeypatch.setattr(materials, "scatter", planted)
    app = _app()
    app.run(1)
    first = app.graph.state["accumulation_image"].clone()
    PROFILER.reset()
    image = app.run(1)
    counters = PROFILER.counters()
    monkeypatch.setattr(materials, "scatter", scatter)
    return first, app.graph.state["accumulation_image"].clone(), image, counters, \
        float(app.graph.state["pt_rays"])


@pytest.fixture(scope="module")
def runs():
    with pytest.MonkeyPatch.context() as mp:
        plain = _frames(mp, plant=False)
        planted = _frames(mp, plant=True)
    return plain, planted


def test_a_zero_or_nan_scatter_direction_ends_the_lane(runs):
    (first, acc, image, _, _), (first_p, acc_p, image_p, counters_p, _) = runs
    assert torch.equal(first, first_p)
    assert torch.isfinite(acc_p).all() and np.isfinite(image_p).all()
    # The planted lanes add nothing past the bounce that ended them: this
    # frame's sample is zero, so their accumulation is the first frame's.
    for px in (ZERO, NAN):
        assert torch.equal(acc_p[px], first[px]), px
        assert not torch.equal(acc[px], first[px]), px
    # Every other pixel is the run without the plant, bit for bit.
    keep = torch.ones((H, W), dtype=torch.bool)
    keep[ZERO] = keep[NAN] = False
    assert torch.equal(acc_p[keep], acc[keep])
    assert np.array_equal(image_p[keep.numpy()], image[keep.numpy()])
    # pt/ended counts exactly the planted lanes, once a frame.
    assert counters_p["pt/ended"] == (1, 2, 2)


def test_the_frame_counts_its_rays_on_the_device(runs):
    (_, _, _, counters, pt_rays), (_, _, _, counters_p, pt_rays_p) = runs
    assert counters["pt/ended"] == (1, 0, 0)
    calls, total, peak = counters["pt/rays"]
    # The sum pt_rays holds; the largest front is a bounce's NEE front
    # (two rays a live lane) or the primary front.
    assert (calls, total) == (1, pt_rays)
    assert H * W <= peak <= 2 * H * W
    # The two ended lanes trace no NEE rays at their bounce and no rays
    # after it.
    assert counters_p["pt/rays"][1] == pt_rays_p < pt_rays
