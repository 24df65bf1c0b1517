"""The port's path-traced frame with the animated marching-cubes isosurface
(BASELINE config 5) against the benchmark's plain reference
(``bench_torch/rrt_reference/pathtraced_mc.py`` and ``marching_cubes.py``:
plain PyTorch, sharing no code with the port), on the CPU at a small size,
so that every run of these tests anchors the reference that the check of
`pt_mc_sponza_1080p` rests on.

The frame is that configuration's (the exact sky, the ReSTIR chain, the
surface extracted at each frame's time and walked beside the scene) at
48x27 with 3 bounces and an 8^3 grid, through the benchmark's own check:
the harness runs the program's plain paths for the units its seed draws,
in the device loop (`still`: the extraction and the refit as its isolated
prefix) and the host loop (`orbit`), the reference replays the run and
renders them from the program's state, and the image, the accumulation,
the spatial reservoirs and the ray count are compared under the cell's
limits. The scene is a small atrium with ten lights and clutter spheres
(the Sponza-sized scene's builder at a smaller tessellation), seen from
the cell's viewpoint, put in place of it on both sides."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_torch")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import cli, manifest, session  # noqa: E402
from rrt_reference import marching_cubes as ref_mc, pathtraced, pathtraced_mc  # noqa: E402
from rrt_reference import rt_materials, scene as ref_scenes  # noqa: E402

from rust_renderer_tpu_torch import models  # noqa: E402
from rust_renderer_tpu_torch.models import create_atrium_standin  # noqa: E402
from rust_renderer_tpu_torch.ops import marching_cubes as port_mc  # noqa: E402

CELL = "pt_mc_sponza_1080p.still"
SMALL = {"width": 48, "height": 27, "static_config": {"num_bounces": 3, "mc_grid": 8}}
# Its still unit 1 and orbit units 1 and 2 are checked: few frames to render.
SEED = 2 ** 32 + 46
ATRIUM = {"columns": 2, "sphere_detail": 8, "clutter_count": 12, "clutter_detail": 6,
          "column_slices": 8}
LIGHTS = [[-9.0 + 2.0 * i, 2.0 + (i % 3), 4.0 - (i % 5) * 2.0] for i in range(10)]


@pytest.fixture
def small_atrium(monkeypatch):
    """The isosurface scene's builder, on both sides, at ATRIUM's
    tessellation, the camera at the cell's viewpoint."""
    config = manifest.load_cell(CELL).config

    def program(renderer, camera):
        camera.set_position_target(config["viewpoint"], config["target"])
        create_atrium_standin(renderer, **ATRIUM)
        for p in LIGHTS:
            renderer.add_light(position=p, color=[1.0, 1.0, 1.0])

    def reference(b):
        b.eye, b.target = [-10.28, 2.10, -0.18], [0.0, 0.5, 0.0]
        ref_scenes._atrium(b, **ATRIUM)
        for p in LIGHTS:
            b.light(p)

    monkeypatch.setattr(models, "create_sponza_scale_mc_scene", program)
    monkeypatch.setattr(ref_scenes, "create_sponza_scale_scene", reference)
    monkeypatch.setitem(rt_materials.ATRIUMS, "create_sponza_scale_scene",
                        (ATRIUM["columns"], ATRIUM["clutter_count"]))


def _cell(mix: str):
    cell = manifest.load_cell(CELL)
    with open(os.path.join(BENCH, "traffic", f"{mix}.json"), encoding="utf-8") as f:
        return dataclasses.replace(cell, traffic=json.load(f))


@pytest.mark.parametrize("mix", ["still", "orbit"])
def test_isosurface_frame_matches_the_reference(small_atrium, mix):
    cell = _cell(mix)
    units = max(session.check_units(SEED, cell.traffic)) + 1
    with torch.no_grad():
        res = cli.run(cell, SEED, 0.0, False, "cpu", size=SMALL, units=units)
    checks = res["checks"]
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] > 0
    compared = {"image", "accumulation_image"} | {
        f"spatial_reuse_reservoirs_{k}" for k in pathtraced.RESERVOIR}
    assert {n.rsplit("_", 1)[0] for n in checks} - {"failed", "units"} == compared | {"pt_rays"}
    assert set(cell.limits) == set(checks) - {"failed_frames", "units_unchecked"}
    # On the CPU the program's plain walks and the reference find the same
    # hits on both trees, and their sums run in the same order but for the
    # sky's integral (last-bit gaps): every pixel is within the check's
    # 1e-3, and the reservoirs and the ray count are equal.
    for name, c in checks.items():
        tight = 1e-5 if name.endswith("_gap") and name != "pt_rays_gap" else 0.0
        assert c["value"] <= tight, (name, c)


@pytest.mark.parametrize("time", [0.0, 437.75])
@pytest.mark.parametrize("grid", [8, 32])
def test_the_reference_extraction_equals_the_port_slot_by_slot(grid, time):
    t = np.float32(time)
    pos, nrm, live = ref_mc.extract(t, grid, "cpu")
    port = port_mc.marching_cubes(grid=grid, voxel_size=32.0 / grid, time=torch.tensor(t))
    assert torch.equal(live, port.valid)
    assert int(live.sum()) > 0
    assert (pos - port.positions).abs().max() <= 1e-6
    assert (nrm - port.normals).abs().max() <= 1e-6


def test_the_reference_table_is_the_port_table():
    assert np.array_equal(ref_mc.table(), port_mc.tables()[0])


def test_the_surface_fills_a_fifth_of_the_small_frame(small_atrium):
    """The primary rays through the small frame's pixel centres find the
    surface nearest on at least 20% of its pixels, so that the check above
    holds the surface's shading to the reference."""
    ref = pathtraced_mc.Reference(_cell("still").config, "cpu", SMALL)
    ref.set_surface(np.float32(300.0))
    u = {k: torch.as_tensor(v) for k, v in ref.camera.uniforms().items()}
    h, w = ref.height, ref.width
    py = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w) + 0.5
    px = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w) + 0.5
    o, d = pathtraced.camera_rays(u["inverse_projection"], u["inverse_view"], px, py, w, h)
    hit = ref.closest(o.reshape(-1, 3).contiguous(), d.reshape(-1, 3))
    on_surface = hit.prim >= ref.atrium.v.shape[0]
    assert float(on_surface.float().mean()) >= 0.2
