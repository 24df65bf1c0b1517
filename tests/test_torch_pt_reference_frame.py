"""The port's path-traced frame against the benchmark's plain reference
(``bench_torch/rrt_reference/pathtraced.py``: plain PyTorch written from the
JAX package's semantics, sharing no code with the port), on the CPU at a
small size, so that every run of these tests anchors the reference that the
check of `pt_sponza_1080p` rests on.

The frame is that configuration's (the exact sky, the ReSTIR chain where
the scene has lights) at 48x27 with 3 bounces, through the benchmark's own
check: the harness runs the program's plain paths for the units its seed
draws, in the device loop (`still`) and the host loop (`orbit`), the
reference replays the run and renders them from the program's state, and
the image, the accumulation, the spatial reservoirs and the ray count are
compared under the cell's limits. Two scenes: the cube scene (no lights, so
no ReSTIR chain) and a small atrium with ten lights and clutter spheres of
all three scattering materials, the Sponza-sized scene's builder at a
smaller tessellation, put in place of it on both sides."""

import dataclasses
import json
import os
import sys

import pytest
import torch

BENCH = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "bench_torch")
if BENCH not in sys.path:
    sys.path.append(BENCH)

from harness import cli, manifest, session  # noqa: E402
from rrt_reference import pathtraced, rt_materials, scene as ref_scenes  # noqa: E402

from rust_renderer_tpu_torch import models  # noqa: E402
from rust_renderer_tpu_torch.models import create_atrium_standin  # noqa: E402

CELL = "pt_sponza_1080p.still"
SMALL = {"width": 48, "height": 27, "static_config": {"num_bounces": 3}}
# Its still unit 1 and orbit units 1 and 2 are checked: few frames to render.
SEED = 2 ** 32 + 46
ATRIUM = {"columns": 2, "sphere_detail": 8, "clutter_count": 12, "clutter_detail": 6,
          "column_slices": 8}
EYE, TARGET = [-10.28, 2.10, -0.18], [0.0, 0.5, 0.0]
LIGHTS = [[-9.0 + 2.0 * i, 2.0 + (i % 3), 4.0 - (i % 5) * 2.0] for i in range(10)]


@pytest.fixture
def small_atrium(monkeypatch):
    """The Sponza-sized scene's builder, on both sides, at ATRIUM's
    tessellation: 12 clutter spheres, Lambertian, metal and dielectric."""

    def program(renderer, camera):
        camera.set_position_target(EYE, TARGET)
        create_atrium_standin(renderer, **ATRIUM)
        for p in LIGHTS:
            renderer.add_light(position=p, color=[1.0, 1.0, 1.0])

    def reference(b):
        b.eye, b.target = EYE, TARGET
        ref_scenes._atrium(b, **ATRIUM)
        for p in LIGHTS:
            b.light(p)

    monkeypatch.setattr(models, "create_sponza_scale_scene", program)
    monkeypatch.setattr(ref_scenes, "create_sponza_scale_scene", reference)
    monkeypatch.setitem(rt_materials.ATRIUMS, "create_sponza_scale_scene",
                        (ATRIUM["columns"], ATRIUM["clutter_count"]))


def _cell(scene: str, mix: str):
    cell = manifest.load_cell(CELL)
    config = dict(cell.config)
    if scene == "cubes":
        config.update(builder="create_cube_scene", viewpoint=[-2.5, 3.0, -2.5],
                      target=[10.0, 1.0, 10.0])
    with open(os.path.join(BENCH, "traffic", f"{mix}.json"), encoding="utf-8") as f:
        return dataclasses.replace(cell, config=config, traffic=json.load(f))


@pytest.mark.parametrize("mix", ["still", "orbit"])
@pytest.mark.parametrize("scene", ["cubes", "atrium"])
def test_path_traced_frame_matches_the_reference(request, scene, mix):
    if scene == "atrium":
        request.getfixturevalue("small_atrium")
    cell = _cell(scene, mix)
    units = max(session.check_units(SEED, cell.traffic)) + 1
    with torch.no_grad():
        res = cli.run(cell, SEED, 0.0, False, "cpu", size=SMALL, units=units)
    checks = res["checks"]
    assert res["correct"], checks
    assert res["failed"] == 0 and res["attempted"] > 0
    compared = {"image", "accumulation_image"} | (
        {f"spatial_reuse_reservoirs_{k}" for k in pathtraced.RESERVOIR} if scene == "atrium"
        else set())
    assert {n.rsplit("_", 1)[0] for n in checks} - {"failed", "units"} == compared | {"pt_rays"}
    # On the CPU the program's plain walks and the reference find the same
    # hits, and their sums run in the same order but for the sky's integral
    # (last-bit gaps, ~1e-6 of a pixel): every pixel is within the check's
    # 1e-3, and the reservoirs and the ray count are equal.
    for name, c in checks.items():
        tight = 1e-5 if name.endswith("_gap") and name != "pt_rays_gap" else 0.0
        assert c["value"] <= tight, (name, c)


def test_the_atrium_shows_every_scattering_material(small_atrium):
    """The primary rays of the small atrium's frame hit Lambertian, metal
    and dielectric surfaces, so the check above holds all three to the
    reference."""
    config = _cell("atrium", "still").config
    ref = pathtraced.Reference(config, "cpu", SMALL)
    u = {k: torch.as_tensor(v) for k, v in ref.camera.uniforms().items()}
    h, w = ref.height, ref.width
    py = torch.arange(h, dtype=torch.float32)[:, None].expand(h, w) + 0.5
    px = torch.arange(w, dtype=torch.float32)[None, :].expand(h, w) + 0.5
    o, d = pathtraced.camera_rays(u["inverse_projection"], u["inverse_view"], px, py, w, h)
    hit = ref.closest(o.reshape(-1, 3).contiguous(), d.reshape(-1, 3))
    sc = ref.scene
    kinds = sc.mat_rt_type[sc.material[hit.prim[hit.is_hit]]]
    assert set(kinds.tolist()) == {0, 1, 2}
    assert (ref.prop[sc.mat_rt_type == 2] > 0).all()
