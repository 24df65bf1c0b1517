"""The check that decides `correct`, driven on the CPU at a tiny size: the
program's plain versions and the reference agree, and a run whose timed
path is broken underneath, or the control in the program's place, comes
out not correct.

The faults a rendering cell can have: a frame that presents the state it
had before (the previous image); half of the image left out; an answer
altered where it is produced (pixels of the presented image). One chip
only, so no exchange between chips to leave out."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from harness import check, cli, manifest

TINY = {"width": 32, "height": 18,
        "static_config": {"shadow_map_size": 256, "cubemap_size": 64, "cubemap_mips": 4,
                          "irradiance_size": 16, "brdf_lut_size": 64}}


def _cell(name, builder=None, config=None, **view):
    """The cell `name`; with `config`, on that configuration file instead."""
    cell = manifest.load_cell(name)
    config = dict(cell.config if config is None else manifest._load_json(
        os.path.join(manifest.BENCH_DIR, "configs", f"{config}.json")))
    if builder is not None:  # a small scene, where the fault and not the scene is tested
        config["builder"] = builder
    config["view"] = {**config.get("view", {}), **view}
    return dataclasses.replace(cell, config=config)


def _over(res) -> list:
    """The compared numbers over their limits."""
    return [k for k, c in res["checks"].items() if c["value"] > c["limit"]]


def _run(cell, seed=2 ** 32 + 17, controls=()):
    units = max(cell.traffic["check_units"]) + 1
    return cli.run(cell, seed, 0.0, False, "cpu", size=TINY, units=units, controls=controls)


@pytest.mark.parametrize("config", ["raster_rtshadows_sponza_1080p", "raster_sponza_1080p"])
@pytest.mark.parametrize("mix", ["still", "orbit"])
def test_program_and_reference_agree_before_fxaa(config, mix):
    # FXAA turns a last-bit difference at a tie of two lumas into a visible
    # one, so the agreement of every pass below it is held without it. On
    # the CPU the program rasterizes the cascades by its brute path.
    res = _run(_cell(f"raster_rtshadows_sponza_1080p.{mix}", config=config, fxaa_enabled=0))
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert res["checks"]["image_gap"]["value"] < 1e-5, res["checks"]


def test_the_references_fxaa_is_the_programs():
    from rrt_reference.raster import fxaa as reference_fxaa
    from rust_renderer_tpu_torch.ops.fxaa import fxaa

    g = torch.Generator().manual_seed(5)
    img = torch.rand(40, 64, 3, generator=g)
    img[10:30, 20:44] *= 0.2  # edges to walk along
    assert torch.equal(reference_fxaa(img), fxaa(img, 0.45, 1, 0))


def _broken_output(monkeypatch, alter):
    """The frame's presented image altered where the frame produces it:
    `render_frame`'s present_output, or the image `run_on_device` returns."""
    from rust_renderer_tpu_torch.app.main import Application

    frame, loop = Application.render_frame, Application.run_on_device

    def render_frame(self):
        res = dict(frame(self))
        res["present_output"] = alter(self, res["present_output"].clone())
        return res

    def run_on_device(self, *args, **kw):
        return alter(self, loop(self, *args, **kw).clone())

    monkeypatch.setattr(Application, "render_frame", render_frame)
    monkeypatch.setattr(Application, "run_on_device", run_on_device)


def test_a_frame_that_presents_its_previous_image_is_not_correct(monkeypatch):
    def stale(app, img):
        previous = getattr(app, "_previous", img)
        app._previous = img
        return previous

    _broken_output(monkeypatch, stale)
    res = _run(_cell("raster_rtshadows_sponza_1080p.orbit", "create_cube_scene"))
    assert not res["correct"]
    assert "image_off" in _over(res)


def test_half_of_the_image_left_out_is_not_correct(monkeypatch):
    def half(app, img):
        img[img.shape[0] // 2:] = 0
        return img

    _broken_output(monkeypatch, half)
    res = _run(_cell("raster_rtshadows_sponza_1080p.orbit", "create_cube_scene"))
    assert not res["correct"]
    assert "image_off" in _over(res)


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    def alter(app, img):
        img[3:9, 5:20] += 0.25
        return img

    _broken_output(monkeypatch, alter)
    res = _run(_cell("raster_rtshadows_sponza_1080p.still", "create_cube_scene"))
    assert not res["correct"]
    assert "image_gap" in _over(res)


def test_a_non_finite_frame_counts_as_failed(monkeypatch):
    def poison(app, img):
        img[0, 0] = float("nan")
        return img

    _broken_output(monkeypatch, poison)
    res = _run(_cell("raster_rtshadows_sponza_1080p.orbit", "create_cube_scene"))
    assert not res["correct"]
    assert res["failed"] == res["attempted"] > 0


@pytest.mark.parametrize("name", ["raster_rtshadows_sponza_1080p.still",
                                  "raster_rtshadows_sponza_1080p.orbit"])
def test_the_bf16_control_is_not_correct(name):
    res = _run(_cell(name, fxaa_enabled=0), controls=("bf16",))
    readings = res["controls"]["bf16"]
    limits = res["checks"]
    assert any(v > limits[k]["limit"] for k, v in readings.items()), readings


def test_the_readings_name_each_compared_plane():
    want = [{"image": np.ones((4, 4, 3), np.float32), "count": 10.0}]
    got = [{"image": np.ones((4, 4, 3), np.float32) * 1.01, "count": 11.0}]
    values = check.readings(got, want)
    assert values["image_off"] == 1.0 and values["count_gap"] == pytest.approx(0.1)
    assert check.readings([{}], want)["image_off"] == 1.0
