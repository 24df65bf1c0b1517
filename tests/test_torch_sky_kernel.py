"""The sky kernel (``csrc/atmosphere.cu``) against its plain version, the
eager loop of ``ops/atmosphere.py::integrate_scattering_plain``.

This file imports torch and the port only, never jax, so that its card
tests run on a GPU machine without jax:

    python -m pytest tests/test_torch_sky_kernel.py -q --noconftest -p no:cacheprovider

Tests marked `cuda` skip where torch sees no GPU. On the card the kernel
and the plain loop take the same CUDA inputs, and every channel must agree
to 2e-6 + 1e-5 |plain|, with NaN where the plain loop gives NaN. The plain
loop runs the same float32 operations in the same order through PyTorch's
kernels, which call the same libdevice expf / powf / sqrtf; the tolerance
allows for a last-bit difference in one of them, which the march carries
into the last digits of the color. The CPU tests show that CPU tensors
take the plain loop and never the kernel.
"""

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.models import create_cube_scene
from rust_renderer_tpu_torch.ops import atmosphere
from rust_renderer_tpu_torch.renderers.passes import _camera_rays
from rust_renderer_tpu_torch.settings import RenderGraphMode, RenderSettings, StaticConfig

# The raster cells' view (bench_torch/configs/raster_rtshadows_sponza_1080p.json).
VIEWPOINT, TARGET = (-10.28, 2.10, -0.18), (0.0, 0.5, 0.0)
WIDTH, HEIGHT = 1920, 1080
SUN = (0.0, 0.90631, 0.42262)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the sky kernel needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _unit(v) -> torch.Tensor:
    return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def _flag(value: int, device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.int32, device=device)


def _plain_sky(o, d, sun, flag):
    """sky_radiance's plain version: the eager loop, clamped and selected."""
    color, _ = atmosphere.integrate_scattering_plain(o, d, 999999999.0, sun, 1.0)
    return torch.where(flag == 1, torch.clamp_max(color, 1.0), 0.0)


def _assert_close(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    excess = (got - want).abs()[ok] - (2e-6 + 1e-5 * want.abs()[ok])
    assert excess.numel() == 0 or float(excess.max()) <= 0.0, (
        f"worst excess {float(excess.max()):.3e}, "
        f"bit-equal share {float((got == want)[ok].float().mean()):.4f}")


def _camera_front(device):
    cam = Camera(list(VIEWPOINT), list(TARGET), aspect_ratio=WIDTH / HEIGHT)
    view = RenderSettings.default().with_camera(cam, WIDTH, HEIGHT).to(device)
    return _camera_rays(view, WIDTH, HEIGHT)


def _edge_rays(device, origin_kind: str):
    """Directions below, along and above the horizon, straight up and down,
    random ones, a zero and a NaN direction; origins on the ground, high in
    the atmosphere, outside it (the rays that enter it advance to it) or
    one a ray."""
    rng = np.random.default_rng(7)
    d = rng.normal(size=(4096, 3)).astype(np.float32)
    d[:8] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1], [0, 1e-3, 1],
             [0, -1e-3, 1], [0.3, 0.05, -0.95], [0.6, -0.2, 0.77]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[8] = 0.0
    d[9] = np.nan
    origins = {
        "ground": [0.0, 1.0, 0.0],
        "high": [2000.0, 60000.0, -3000.0],
        "outside": [0.0, 300000.0, 0.0],
    }
    if origin_kind == "per_ray":
        o = rng.uniform(-1.0, 1.0, (4096, 3)) * [2e5, 1.5e5, 2e5] + [0.0, 1e5, 0.0]
    else:
        o = np.broadcast_to(np.asarray(origins[origin_kind], np.float64), (4096, 3))
    return (torch.tensor(np.ascontiguousarray(o), dtype=torch.float32, device=device),
            torch.tensor(d, device=device))


@pytest.mark.cuda
@pytest.mark.parametrize("enabled", [1, 0])
def test_sky_kernel_matches_plain_on_the_1080p_front(cuda_device, enabled):
    """The atmosphere pass's call: 1080p camera rays of the raster cells'
    view, one origin broadcast over them."""
    o, d = _camera_front(cuda_device)
    assert o.stride()[:-1] == (0, 0)
    sun, flag = _unit(torch.tensor(SUN, device=cuda_device)), _flag(enabled, cuda_device)
    got = atmosphere.sky_radiance(o, d, sun, flag)
    want = _plain_sky(o, d, sun, flag)
    _assert_close(got, want)
    if not enabled:
        assert not bool(got.any())


@pytest.mark.cuda
@pytest.mark.parametrize("origin_kind", ["ground", "high", "outside", "per_ray"])
def test_sky_kernel_matches_plain_on_edge_rays(cuda_device, origin_kind):
    """integrate_scattering's color and transmittance (also with a shorter
    ray and a brighter light), and sky_radiance with the sky on and off, on
    the edge rays; the zero and NaN directions give what the plain loop
    gives (NaN, or 0 with the sky off)."""
    o, d = _edge_rays(cuda_device, origin_kind)
    sun = _unit(torch.tensor(SUN, device=cuda_device))
    for ray_length, light_color in ((999999999.0, 1.0), (5e4, 2.0)):
        got = atmosphere.integrate_scattering(o, d, ray_length, sun, light_color)
        want = atmosphere.integrate_scattering_plain(o, d, ray_length, sun, light_color)
        for g, w in zip(got, want):
            _assert_close(g, w)
    for enabled in (1, 0):
        flag = _flag(enabled, cuda_device)
        _assert_close(atmosphere.sky_radiance(o, d, sun, flag), _plain_sky(o, d, sun, flag))
    assert bool(torch.isnan(want[0][8:10]).all())
    # A (3,) origin is the broadcast one's.
    if origin_kind != "per_ray":
        flag = _flag(1, cuda_device)
        assert torch.equal(atmosphere.sky_radiance(o[0], d, sun, flag).nan_to_num(7.0),
                           atmosphere.sky_radiance(o, d, sun, flag).nan_to_num(7.0))


@pytest.mark.cuda
def test_sky_kernel_replays_from_a_captured_graph(cuda_device):
    """A captured launch replays with the sun and the sky flag that the
    tensors hold at replay time, bit for bit the eager launch's colors."""
    o, d = _camera_front(cuda_device)
    sun = _unit(torch.tensor(SUN, device=cuda_device))
    flag = _flag(1, cuda_device)
    eager = atmosphere.sky_radiance(o, d, sun, flag)  # built and loaded before the capture
    stream = torch.cuda.Stream(cuda_device)
    stream.wait_stream(torch.cuda.current_stream(cuda_device))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = atmosphere.sky_radiance(o, d, sun, flag)
    torch.cuda.current_stream(cuda_device).wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    sun.copy_(_unit(torch.tensor((0.3, 0.2, -0.9), device=cuda_device)))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, atmosphere.sky_radiance(o, d, sun, flag))
    assert not torch.equal(out, eager)
    flag.fill_(0)
    graph.replay()
    torch.cuda.synchronize()
    assert not bool(out.any())


@pytest.mark.cuda
def test_sky_launches_count_each_call_and_its_rays(cuda_device):
    o, d = _edge_rays(cuda_device, "per_ray")
    sun = _unit(torch.tensor(SUN, device=cuda_device))
    before = atmosphere.SKY_LAUNCHES.copy()
    atmosphere.sky_radiance(o, d, sun, _flag(1, cuda_device))
    assert atmosphere.SKY_LAUNCHES["launches"] == before["launches"] + 1
    assert atmosphere.SKY_LAUNCHES["rays"] == before["rays"] + 4096
    atmosphere.integrate_scattering(o[:100], d[:100], 5e4, sun, 2.0)
    assert atmosphere.SKY_LAUNCHES["launches"] == before["launches"] + 2
    assert atmosphere.SKY_LAUNCHES["rays"] == before["rays"] + 4196


@pytest.mark.cuda
def test_cuda_tensors_never_run_the_plain_loop(cuda_device, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain loop ran on CUDA tensors")

    monkeypatch.setattr(atmosphere, "integrate_scattering_plain", refuse)
    o, d = _edge_rays(cuda_device, "ground")
    sun = _unit(torch.tensor(SUN, device=cuda_device))
    atmosphere.sky_radiance(o, d, sun, _flag(1, cuda_device))
    atmosphere.integrate_scattering(o, d, 999999999.0, sun, 1.0)
    # A per-ray ray_length is not a form the kernel takes.
    with pytest.raises(ValueError, match="ray_length"):
        atmosphere.integrate_scattering(o, d, torch.full(d.shape[:-1], 1e5, device=cuda_device),
                                        sun, 1.0)


@pytest.mark.cuda
def test_a_rasterized_frame_launches_the_sky_kernel_twice(cuda_device):
    """The atmosphere pass and the reflections' misses: two launches a
    RASTERIZED frame, each over every pixel."""
    cfg = StaticConfig(shadow_map_size=128, cubemap_size=16, cubemap_mips=4,
                       irradiance_size=8, brdf_lut_size=16)
    app = Application(64, 48, RenderGraphMode.RASTERIZED, cfg=cfg, device=cuda_device)
    app.create_scene(create_cube_scene)
    app.run(1)
    before = atmosphere.SKY_LAUNCHES.copy()
    app.run(2)
    assert atmosphere.SKY_LAUNCHES["launches"] - before["launches"] == 4
    assert atmosphere.SKY_LAUNCHES["rays"] - before["rays"] == 4 * 64 * 48


@pytest.mark.parametrize("call", ["sky_radiance", "integrate_scattering"])
def test_cpu_tensors_take_the_plain_loop(call, monkeypatch):
    """On the CPU both functions run the plain loop, once a call, and the
    kernel's counter stays where it was."""
    ran = []
    plain = atmosphere.integrate_scattering_plain

    def counted(*args):
        ran.append(args)
        return plain(*args)

    monkeypatch.setattr(atmosphere, "integrate_scattering_plain", counted)
    o, d = _edge_rays("cpu", "high")
    o, d = o[:64], d[:64]
    sun = _unit(torch.tensor(SUN))
    before = atmosphere.SKY_LAUNCHES.copy()
    if call == "sky_radiance":
        got = atmosphere.sky_radiance(o, d, sun, _flag(1, "cpu"))
        want = torch.clamp_max(plain(o, d, 999999999.0, sun, 1.0)[0], 1.0)
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
    else:
        got = atmosphere.integrate_scattering(o, d, 999999999.0, sun, 1.0)
        for g, w in zip(got, plain(o, d, 999999999.0, sun, 1.0)):
            assert torch.equal(g.nan_to_num(7.0), w.nan_to_num(7.0))
    assert len(ran) == 1
    assert atmosphere.SKY_LAUNCHES == before


def test_other_devices_raise():
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="no scattering integral"):
        atmosphere.integrate_scattering(o, o, 999999999.0, torch.zeros(3, device="meta"), 1.0)
