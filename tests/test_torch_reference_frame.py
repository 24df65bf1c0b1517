"""The port's cascaded RASTERIZED frame against the benchmark's plain
reference (``bench_torch/rrt_reference``: plain PyTorch written from the
JAX package's semantics, sharing no code with the port), on the CPU at a
small size, so that every run of these tests anchors the reference that the
benchmark's check of `raster_sponza_1080p` rests on.

The frame is that configuration's (four cascades, shadows on) on the cube
scene at 64x36 with 512² cascades, FXAA off (it turns a last-bit difference
at a tie of two lumas into a visible one), through the benchmark's own
check: the harness runs the program's plain paths for the units its seed
draws, the reference renders them, and the images are compared under the
cell's limits. The cascades are rasterized by K4's plain version (the
card's arithmetic) and by the brute path; the frame with its shadows off
differs, so the cascades are seen."""

import dataclasses
import os
import sys

import numpy as np
import pytest

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_torch")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import cli, manifest, session  # noqa: E402

CELL = "raster_sponza_1080p.still"
SMALL = {"width": 64, "height": 36,
         "static_config": {"shadow_map_size": 512, "cubemap_size": 64, "cubemap_mips": 4,
                           "irradiance_size": 16, "brdf_lut_size": 64}}
SEED = 2 ** 32 + 23


def _cell(**view):
    cell = manifest.load_cell(CELL)
    config = {**cell.config, "builder": "create_cube_scene",
              "view": {**cell.config["view"], "fxaa_enabled": 0, **view}}
    return dataclasses.replace(cell, config=config)


def _size(method):
    return {**SMALL, "static_config": {**SMALL["static_config"], "raster_method": method}}


@pytest.mark.parametrize("method", ["binned", "brute"])
def test_cascaded_raster_frame_matches_the_reference(method):
    cell = _cell()
    units = max(cell.traffic["check_units"]) + 1
    res = cli.run(cell, SEED, 0.0, False, "cpu", size=_size(method), units=units)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    # Two pixels of 2,304 at most: a PCF tap whose depth lies within float32
    # rounding of the 0.0005 bias (one here, 6e-8 from it) may flip.
    assert res["checks"]["image_off"]["value"] <= 0.001, res["checks"]
    assert res["checks"]["image_gap"]["value"] < 1e-4, res["checks"]


def test_the_cascades_are_seen_in_the_frame():
    images = []
    for shadows in (1, 0):
        program = session.Program(_cell(shadows_enabled=shadows), SEED, "cpu", _size("binned"))
        images.append(np.asarray(program.unit(warm_up=True), np.float32))
        program.close()
    assert np.abs(images[0] - images[1]).max(axis=-1).mean() > 0.01
