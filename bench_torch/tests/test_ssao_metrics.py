"""The SSAO kernels' per-layer readers (`kernels.ssao_ms`,
`kernels.ssao_ms.orbit`) on a synthetic trace: they sum only the two SSAO
kernels' records in the window, read None where the program has no such
kernel, and the kernels are left out of `kernels.torch_ms`."""

import pytest

from harness import cli, manifest, trace

DEPTH = "(anonymous namespace)::ssao_depth_kernel(SsaoArgs)"
OCCLUSION = "(anonymous namespace)::ssao_occlusion_kernel(SsaoArgs)"


def _chrome(with_ssao: bool = True):
    win = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_RANGE, "ts": 1000.0,
           "dur": 1000.0}
    k = lambda name, ts, dur: {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": dur}
    events = [
        win,
        k("(anonymous namespace)::deferred_shade_kernel(DeferredArgs)", 1050.0, 100.0),
        k("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, "
          "float, float, at::native::binary_internal::MulFunctor<float> > >(int, float)",
          1200.0, 30.0),
        # Outside the window: not counted.
        k(OCCLUSION, 3000.0, 500.0),
    ]
    if with_ssao:
        events += [
            k(DEPTH, 1300.0, 10.0),
            k(OCCLUSION, 1320.0, 290.0),
            k("_GLOBAL__N__7a1c0e2f_7_ssao_cu_1f3b5d7a::ssao_depth_kernel(SsaoArgs)", 1650.0,
              12.0),
            k("_GLOBAL__N__7a1c0e2f_7_ssao_cu_1f3b5d7a::ssao_occlusion_kernel(SsaoArgs)",
              1670.0, 288.0),
        ]
    return events


def _readings(tr):
    r = cli.Readings.__new__(cli.Readings)
    r.trace, r.rays = tr, None
    r.port_kernels = {"deferred_shade_kernel", "ssao_depth_kernel", "ssao_occlusion_kernel"}
    return r


@pytest.mark.parametrize("metric", ["kernels.ssao_ms", "kernels.ssao_ms.orbit"])
def test_ssao_ms_reads_only_the_ssao_kernels(metric):
    r = _readings(trace.from_chrome(_chrome(), frames=2))
    # The four SSAO records in the window, 600 us over 2 frames.
    assert manifest.load_reader(metric)(r) == pytest.approx(0.3)
    # The SSAO kernels are the program's own: the eager kernels leave them out.
    assert manifest.load_reader("kernels.torch_ms")(r) == pytest.approx(0.015)
    assert manifest.load_reader("kernels.deferred_ms")(r) == pytest.approx(0.05)


@pytest.mark.parametrize("metric", ["kernels.ssao_ms", "kernels.ssao_ms.orbit"])
def test_ssao_ms_reads_none_without_the_kernels(metric):
    r = _readings(trace.from_chrome(_chrome(with_ssao=False), frames=2))
    assert manifest.load_reader(metric)(r) is None
    r.trace = None
    assert manifest.load_reader(metric)(r) is None


def test_the_ssao_kernels_are_kernels_of_the_program():
    names = trace.port_kernel_names(f"{manifest.ROOT}/rust_renderer_tpu_torch")
    assert {"ssao_depth_kernel", "ssao_occlusion_kernel"} <= names
