"""The sky kernel's per-layer readers (`kernels.sky_ms`, `kernels.sky_ms.orbit`)
on a synthetic trace: they sum only the sky kernel's records, and read None
where the program has no such kernel."""

import pytest

from harness import cli, manifest, trace


def _chrome(with_sky: bool = True):
    win = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_RANGE, "ts": 1000.0,
           "dur": 1000.0}
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    events = [
        win,
        k("void (anonymous namespace)::k1_traverse_wide_kernel<false, false>(float const*, int)",
          1050.0, 100.0),
        k("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, "
          "float, float, at::native::binary_internal::MulFunctor<float> > >(int, float)",
          1200.0, 30.0),
        k("(anonymous namespace)::seed_occlusion_kernel(float const*, float const*)",
          1250.0, 20.0),
        # Outside the window: not counted.
        k("(anonymous namespace)::sky_scatter_kernel(float const*, int, float const*, "
          "float const*, int const*, float, float, int, float*, float*)", 3000.0, 500.0),
    ]
    if with_sky:
        events += [
            k("(anonymous namespace)::sky_scatter_kernel(float const*, int, float const*, "
              "float const*, int const*, float, float, int, float*, float*)", 1300.0, 80.0),
            k("_GLOBAL__N__41cbc0db_13_atmosphere_cu_13d07f77::sky_scatter_kernel(float const*, "
              "int)", 1500.0, 70.0),
        ]
    return events


def _readings(tr):
    r = cli.Readings.__new__(cli.Readings)
    r.trace, r.rays = tr, None
    r.port_kernels = {"k1_traverse_wide_kernel", "seed_occlusion_kernel", "sky_scatter_kernel"}
    return r


@pytest.mark.parametrize("metric", ["kernels.sky_ms", "kernels.sky_ms.orbit"])
def test_sky_ms_reads_only_the_sky_kernel(metric):
    r = _readings(trace.from_chrome(_chrome(), frames=2))
    # The two sky records in the window, 150 us over 2 frames.
    assert manifest.load_reader(metric)(r) == pytest.approx(0.075)
    # The sky kernel is the program's own: the eager kernels leave it out.
    assert manifest.load_reader("kernels.torch_ms")(r) == pytest.approx(0.015)


@pytest.mark.parametrize("metric", ["kernels.sky_ms", "kernels.sky_ms.orbit"])
def test_sky_ms_reads_none_without_the_kernel(metric):
    r = _readings(trace.from_chrome(_chrome(with_sky=False), frames=2))
    assert manifest.load_reader(metric)(r) is None
    r.trace = None
    assert manifest.load_reader(metric)(r) is None


def test_the_sky_kernel_is_a_kernel_of_the_program():
    names = trace.port_kernel_names(f"{manifest.ROOT}/rust_renderer_tpu_torch")
    assert "sky_scatter_kernel" in names
