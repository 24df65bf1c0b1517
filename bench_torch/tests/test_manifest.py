"""Cells are found by name: a configuration, a traffic mix, a limit file
and a per-layer metric added as new files, with new entries in
BENCHMARK.json, are found with no edit to a file already there."""

import json
import os
import shutil

from harness import manifest

NEW_METRIC = '''"""A metric added by a later change."""


def read(r):
    return 2.0 * r.window_frames
'''


def test_added_files_are_found(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "bench_torch"
    shutil.copytree(manifest.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "rrt_reference"))
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    doc["configs"].append({"name": "cubes_512", "source": "https://example.org/cubes",
                           "file": "bench_torch/configs/cubes_512.json", "reduced": [],
                           "why": "a later configuration"})
    doc["workloads"].append({"name": "cubes_512.sweep", "config": "cubes_512",
                             "traffic": "sweep", "chips": 1, "why": "a later cell"})
    next(m for m in doc["end_to_end"] if m["name"] == "frame_ms")["workloads"].append(
        "cubes_512.sweep")
    doc["per_layer"].append({"name": "later.metric", "unit": "count", "better": "lower",
                             "source": "program_counter", "layer": "App frame loop",
                             "moves": "frame_ms", "workloads": ["cubes_512.sweep"]})
    (root / "BENCHMARK.json").write_text(json.dumps(doc))
    (bench / "configs" / "cubes_512.json").write_text(json.dumps(
        {"builder": "create_cube_scene", "mode": "RASTERIZED", "width": 512, "height": 512}))
    (bench / "traffic" / "sweep.json").write_text(json.dumps(
        {"loop": "device", "frames_per_call": 2, "checks": 1, "check_units": [1, 2]}))
    (bench / "limits" / "cubes_512.sweep.json").write_text(json.dumps({"image_off": 0.001}))
    (bench / "metrics" / "later.metric.py").write_text(NEW_METRIC)

    cell = manifest.load_cell("cubes_512.sweep", root=str(root), bench_dir=str(bench))
    assert cell.config["builder"] == "create_cube_scene"
    assert cell.traffic["frames_per_call"] == 2
    assert cell.limits == {"image_off": 0.001}
    assert "later.metric" in [m["name"] for m in cell.per_layer]
    # Metrics that list other cells are not this cell's.
    assert "kernels.k1_ms" not in [m["name"] for m in cell.per_layer]
    assert [m["name"] for m in cell.end_to_end] == ["frame_ms", "setup_s"]

    class R:
        window_frames = 5
    assert manifest.load_reader("later.metric", bench_dir=str(bench))(R()) == 10.0
    # The cells already there are found as before.
    old = manifest.load_cell("raster_rtshadows_sponza_1080p.still", root=str(root), bench_dir=str(bench))
    assert old.config["mode"] == "RASTERIZED"
    assert "frame_ms_p90" not in [m["name"] for m in old.end_to_end]
    orbit = manifest.load_cell("raster_rtshadows_sponza_1080p.orbit", root=str(root), bench_dir=str(bench))
    assert "frame_ms_p90" in [m["name"] for m in orbit.end_to_end]


def test_every_cell_of_the_benchmark_has_its_files():
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json")) as f:
        doc = json.load(f)
    for w in doc["workloads"]:
        cell = manifest.load_cell(w["name"])
        assert cell.per_layer and cell.end_to_end
    for m in doc["per_layer"]:
        assert callable(manifest.load_reader(m["name"]))
