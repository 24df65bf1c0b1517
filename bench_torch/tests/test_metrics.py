"""The end-to-end and per-layer arithmetic on synthetic numbers and a
synthetic trace."""

import statistics

import pytest

from harness import cli, manifest, stats, trace


def test_p90_is_taken_over_every_frame():
    # Ten 1-second chunks of frames: the slow frames sit in one chunk, so a
    # percentile of per-chunk means would hide them.
    frames = [100.0] * 90 + [300.0] * 10
    assert stats.percentile(frames, 90) == pytest.approx(120.0)
    chunk_means = [statistics.mean(frames[i:i + 10]) for i in range(0, 100, 10)]
    assert stats.percentile(chunk_means, 90) < 120.0
    assert stats.percentile([5.0], 90) == 5.0
    assert stats.percentile(list(range(11)), 50) == 5.0


def _chrome():
    win = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_RANGE, "ts": 1000.0,
           "dur": 1000.0}
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    return [
        win,
        {"ph": "X", "cat": "user_annotation", "name": "frame", "ts": 1000.0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "build_graph", "ts": 1000.0, "dur": 150.0},
        # Two overlapping kernels and a copy: busy [1100, 1300] and [1500, 1600].
        k("void (anonymous namespace)::k1_traverse_wide_kernel<false, false>(float const*, int)",
          1100.0, 150.0),
        k("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor<float> >"
          "(int, float)", 1200.0, 100.0),
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoH", "ts": 1500.0, "dur": 100.0},
        k("(anonymous namespace)::k4_depth_kernel(float const*, int)", 1700.0, 50.0),
        # Outside the window: not counted.
        k("void (anonymous namespace)::k1_traverse_wide_kernel<true, false>(float const*)",
          3000.0, 10.0),
    ]


def test_idle_share_is_one_minus_the_union_of_device_intervals():
    tr = trace.from_chrome(_chrome(), frames=2)
    assert tr.window_s == pytest.approx(1e-3)
    # Busy: [1100, 1300] + [1500, 1600] + [1700, 1750] = 350 us of 1000.
    assert tr.busy_s() == pytest.approx(350e-6)
    r = cli.Readings.__new__(cli.Readings)
    r.trace = tr
    assert manifest.load_reader("device.idle_share")(r) == pytest.approx(65.0)
    gaps = tr.idle_gaps({"frame", "build_graph"})
    assert gaps[0] == ["frame", pytest.approx(250e-6)]  # [1750, 2000]
    assert gaps[1] == ["frame", pytest.approx(200e-6)]  # [1300, 1500]
    assert ["build_graph", pytest.approx(100e-6)] in gaps  # [1000, 1100]
    assert [name for name, _ in tr.device_ops()][0] == \
        "(anonymous namespace)::k1_traverse_wide_kernel<false, false>"


def test_kernel_names_and_the_ports_own():
    names = trace.port_kernel_names(f"{manifest.ROOT}/rust_renderer_tpu_torch")
    assert {"k1_traverse_wide_kernel", "k4_depth_kernel", "seed_occlusion_kernel"} <= names
    assert trace.base_name("void (anonymous namespace)::k1_traverse_wide_kernel<true, false>"
                           "(float const*, int*)") == "k1_traverse_wide_kernel"
    assert trace.base_name("(anonymous namespace)::k4_depth_kernel(float const*)") == \
        "k4_depth_kernel"
    assert trace.base_name("void at::native::elementwise_kernel<128, 2>(int)") == \
        "elementwise_kernel"


def _readings(tr, rays=None, mode="RASTERIZED"):
    r = cli.Readings.__new__(cli.Readings)
    r.trace, r.rays = tr, rays
    r.config = {"mode": mode, "scene_triangles": 1000,
                "static_config": {"shadow_map_size": 64}}
    r.port_kernels = {"k1_traverse_wide_kernel", "k4_depth_kernel"}
    return r


def test_k1_and_k4_logical_bytes():
    tr = trace.from_chrome(_chrome(), frames=2)
    k1 = _readings(tr, rays=(100, 50))
    # One K1 launch in the window: 100 closest rays at 28 + 16 B, 50
    # any-hit rays at 28 + 4 B, and 1000 triangles at 36 B.
    least = (100 * 44 + 50 * 32 + 1000 * 36) / 3.35e12
    assert manifest.load_reader("kernels.k1_roofline")(k1) == pytest.approx(
        100.0 * least / 150e-6)
    assert manifest.load_reader("kernels.k1_ms")(k1) == pytest.approx(150e-3 / 2)
    # One K4 launch: 1000 triangles at 36 B and a 64 x 64 map at 4 B.
    least = (1000 * 36 + 64 * 64 * 4) / 3.35e12
    assert manifest.load_reader("kernels.k4_roofline")(k1) == pytest.approx(
        100.0 * least / 50e-6)
    # The eager kernels: only the fill, 100 us over 2 frames.
    assert manifest.load_reader("kernels.torch_ms")(k1) == pytest.approx(0.05)
    assert manifest.load_reader("graph.kernels_per_frame")(k1) == 1.5


def test_a_reader_with_nothing_to_read_returns_nothing():
    tr = trace.from_chrome([e for e in _chrome() if "k4" not in e["name"]], frames=2)
    r = _readings(tr, rays=(1, 1))
    assert manifest.load_reader("kernels.k4_roofline")(r) is None
    assert manifest.load_reader("kernels.k4_ms")(r) is None
    r.rays = None
    assert manifest.load_reader("kernels.k1_roofline")(r) is None


def test_orbit_idle_share_reads_the_traced_busy_time_over_the_untraced_frame():
    tr = trace.from_chrome(_chrome(), frames=2)
    r = _readings(tr)
    # 350 us busy over 2 traced frames against an untraced window of 4
    # frames in 1 ms: 175 of 250 us a frame.
    r.window_frames, r.window_s = 4, 1e-3
    assert manifest.load_reader("device.idle_share.orbit")(r) == pytest.approx(30.0)
    r.window_frames = 0
    assert manifest.load_reader("device.idle_share.orbit")(r) is None
