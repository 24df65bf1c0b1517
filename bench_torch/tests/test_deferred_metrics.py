"""The deferred kernel's per-layer readers (`kernels.deferred_ms`,
`kernels.deferred_ms.orbit`) on a synthetic trace: they sum only the
deferred kernel's records in the window, and read None where the program has
no such kernel."""

import pytest

from harness import cli, manifest, trace

DEFERRED = "(anonymous namespace)::deferred_shade_kernel(DeferredArgs)"


def _chrome(with_deferred: bool = True):
    win = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_RANGE, "ts": 1000.0,
           "dur": 1000.0}
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    events = [
        win,
        k("(anonymous namespace)::sky_scatter_kernel(float const*, int, float const*, "
          "float const*, int const*, float, float, int, float*, float*)", 1050.0, 100.0),
        k("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, "
          "float, float, at::native::binary_internal::MulFunctor<float> > >(int, float)",
          1200.0, 30.0),
        # Outside the window: not counted.
        k(DEFERRED, 3000.0, 500.0),
    ]
    if with_deferred:
        events += [
            k(DEFERRED, 1300.0, 90.0),
            k("_GLOBAL__N__2f0c1a7e_11_deferred_cu_5b2c9e11::deferred_shade_kernel("
              "DeferredArgs)", 1500.0, 110.0),
        ]
    return events


def _readings(tr):
    r = cli.Readings.__new__(cli.Readings)
    r.trace, r.rays = tr, None
    r.port_kernels = {"sky_scatter_kernel", "deferred_shade_kernel"}
    return r


@pytest.mark.parametrize("metric", ["kernels.deferred_ms", "kernels.deferred_ms.orbit"])
def test_deferred_ms_reads_only_the_deferred_kernel(metric):
    r = _readings(trace.from_chrome(_chrome(), frames=2))
    # The two deferred records in the window, 200 us over 2 frames.
    assert manifest.load_reader(metric)(r) == pytest.approx(0.1)
    # The deferred kernel is the program's own: the eager kernels leave it out.
    assert manifest.load_reader("kernels.torch_ms")(r) == pytest.approx(0.015)
    assert manifest.load_reader("kernels.sky_ms")(r) == pytest.approx(0.05)


@pytest.mark.parametrize("metric", ["kernels.deferred_ms", "kernels.deferred_ms.orbit"])
def test_deferred_ms_reads_none_without_the_kernel(metric):
    r = _readings(trace.from_chrome(_chrome(with_deferred=False), frames=2))
    assert manifest.load_reader(metric)(r) is None
    r.trace = None
    assert manifest.load_reader(metric)(r) is None


def test_the_deferred_kernel_is_a_kernel_of_the_program():
    names = trace.port_kernel_names(f"{manifest.ROOT}/rust_renderer_tpu_torch")
    assert "deferred_shade_kernel" in names
