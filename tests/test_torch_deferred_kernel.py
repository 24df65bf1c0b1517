"""The deferred kernel (``csrc/deferred.cu``) and its plain version,
``ops/deferred.py::deferred_composite_plain``.

This file imports torch and the port only, never jax, so that its card
tests run on a GPU machine without jax:

    python -m pytest tests/test_torch_deferred_kernel.py -q --noconftest -p no:cacheprovider

On the CPU, `deferred_composite` runs the plain body (held to the JAX
deferred pass in tests/test_torch_deferred_jax.py) without touching the
kernel's counter, and drops a NaN light beyond `num_lights`; the CUDA
wrapper's launch block reads every input in place and refuses one of
another type or layout.

Tests marked `cuda` skip where torch sees no GPU. On the card the kernel
and the plain version take the inputs of the Sponza-scale scene's 1080p
deferred pass, with a band of positions planted at view depths in every
cascade's range, and every channel must agree to 1e-5 x max(1, |plain|):
the kernel runs the plain version's float32 operations in its order, and
the tolerance allows for a last-bit difference in a norm's sum, a powf or a
division, carried through the lights' sum.
"""

import ctypes
import itertools
import re
import types

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.ops import deferred, pbr, shadow
from rust_renderer_tpu_torch.settings import RenderSettings

TOGGLES = ("ibl_enabled", "shadows_enabled", "raytracing_supported", "cascade_debug",
           "ssao_enabled")
COMBOS = list(itertools.product((0, 1), repeat=len(TOGGLES)))
LIGHT_COUNTS = (0, 3, 10)
RTOL = 1e-5
# The Sponza-scale scene's viewpoint (models/scenes.py::create_sponza_scale_scene).
VIEWPOINT, TARGET = (-10.28, 2.10, -0.18), (0.0, 0.5, 0.0)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the deferred kernel needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _view(camera: Camera, num_lights: int, combo, device) -> RenderSettings:
    view = RenderSettings.default(camera.get_view(), camera.get_projection(),
                                  camera.get_position(), num_lights=num_lights)
    return view.replace(**{k: np.int32(v) for k, v in zip(TOGGLES, combo)}).to(device)


# -- the CPU inputs: a small image of random surfaces --------------------------


def _scene(rng, n_materials: int = 6, n_lights: int = 10):
    """The material and light tables the pass reads: materials of every ray
    tracing type (1 is metal), lights of every type (0 directional, 1
    point, 2 spot)."""
    f = lambda *shape, lo=0.0, hi=1.0: torch.tensor(rng.uniform(lo, hi, shape),
                                                    dtype=torch.float32)
    light_dir = rng.normal(size=(n_lights, 3))
    light_dir[3] = 0.0  # a zero direction: _unit's clamp
    return types.SimpleNamespace(
        mat_base_color=f(n_materials, 4, lo=0.2), mat_metallic=f(n_materials),
        mat_roughness=f(n_materials, lo=0.05),
        mat_rt_type=torch.tensor([0, 1, 0, 2, 1, 3][:n_materials], dtype=torch.int32),
        light_color=f(n_lights, 4, lo=0.5, hi=4.0),
        light_pos=f(n_lights, 3, lo=-6.0, hi=6.0) + torch.tensor([0.0, 4.0, 0.0]),
        light_dir=torch.tensor(light_dir, dtype=torch.float32),
        light_type=torch.tensor([(1.0, 2.0, 0.0)[i % 3] for i in range(n_lights)]),
        light_att=torch.tensor([[1.0, 0.09, 0.032]] * n_lights) * f(n_lights, 1, lo=0.5,
                                                                    hi=2.0),
        light_spot=f(n_lights, lo=1.0, hi=16.0))


def plant_cascades(position: torch.Tensor, camera: Camera, splits) -> None:
    """Overwrite `position`'s (rows, W, 4) rows with points ahead of the
    camera at view depths from 0.5 to 1.25x the last cascade's near split
    across the columns (so in every cascade's range), spread sideways over
    the rows."""
    rows, width = position.shape[:2]
    view = torch.tensor(np.asarray(camera.get_view(), np.float32))
    eye = torch.tensor(np.asarray(camera.get_position(), np.float32))
    depth = torch.linspace(0.5, 1.25 * float(splits[-2]), width)
    side = torch.linspace(-2.0, 2.0, rows)
    points = (eye + depth[None, :, None] * -view[2, :3] + side[:, None, None] * view[0, :3]
              + 0.25 * side.flip(0)[:, None, None] * view[1, :3])
    position[..., :3] = points.to(position.device)
    position[..., 3] = 1.0


def _cpu_inputs(height: int = 12, width: int = 20, seed: int = 11):
    """(camera, scene, planes): random positions around the viewpoint's
    target (rows 2-4 planted in every cascade), normals, albedo (a few
    negative), pbr with material ids in and out of the table, a row of sky
    pixels (every plane at its clear value 1.0), random reflections, binary
    RT shadows, SSAO, shadow cascades fitted to the camera, and a small
    environment."""
    rng = np.random.default_rng(seed)
    f = lambda *shape, lo=0.0, hi=1.0: torch.tensor(rng.uniform(lo, hi, shape),
                                                    dtype=torch.float32)
    camera = Camera(list(VIEWPOINT), list(TARGET), aspect_ratio=width / height)
    scene = _scene(rng)
    hw = (height, width)
    position = torch.cat([f(*hw, 3, lo=-8.0, hi=8.0) * torch.tensor([1.0, 0.4, 0.5])
                          + torch.tensor([0.0, 3.0, 0.0]), torch.ones(*hw, 1)], -1)
    n = torch.tensor(rng.normal(size=(*hw, 3)), dtype=torch.float32)
    normal = torch.cat([n / n.norm(dim=-1, keepdim=True), torch.zeros(*hw, 1)], -1)
    albedo = f(*hw, 4, lo=-0.1)
    material = torch.tensor(rng.integers(-1, 8, hw), dtype=torch.float32)
    pbr_plane = torch.stack([f(*hw), f(*hw), f(*hw), material], -1)
    vp, splits = shadow.cascade_matrices(camera.get_view(), camera.get_projection(),
                                         camera.get_near_plane(), camera.get_far_plane(),
                                         np.asarray((0.0, 0.90631, 0.42262), np.float32))
    plant_cascades(position[2:5], camera, splits)
    planes = dict(position=position, normal=normal, albedo=albedo, pbr=pbr_plane)
    for name in planes:
        planes[name][0] = 1.0  # sky
    planes.update(
        rt_reflections=f(*hw, 4), rt_shadows=torch.tensor(
            rng.integers(0, 2, hw), dtype=torch.float32),
        ssao=f(*hw), shadow_map=f(4, 64, 64, lo=0.9), cascade_vp=torch.tensor(vp),
        cascade_splits=torch.tensor(splits), irradiance_map=f(6, 8, 8, 3),
        specular_map=[f(6, s, s, 3) for s in (32, 16, 8, 4, 2, 1)],
        brdf_lut=f(16, 16, 2))
    return camera, scene, planes


def cascades_reached(p, view) -> set:
    """The cascades the plain body picks over the planes `p`."""
    _, cascade = shadow.calculate_shadow(p["position"][..., :3], view.view, p["shadow_map"],
                                         p["cascade_vp"], p["cascade_splits"])
    return set(cascade.unique().tolist())


def _call(fn, scene, view, p):
    return fn(scene, view, p["position"], p["normal"], p["albedo"], p["pbr"],
              p["rt_reflections"], p["rt_shadows"], p["ssao"], p["shadow_map"],
              p["cascade_vp"], p["cascade_splits"], p["irradiance_map"], p["specular_map"],
              p["brdf_lut"])


def test_cpu_inputs_reach_every_cascade():
    camera, _, p = _cpu_inputs()
    assert cascades_reached(p, _view(camera, 0, (1,) * 5, "cpu")) == {0, 1, 2, 3}


def test_cpu_composite_ignores_lights_beyond_num_lights():
    """A light at or beyond view.num_lights contributes nothing, NaN or not."""
    camera, scene, p = _cpu_inputs()
    view = _view(camera, 3, (1, 1, 1, 0, 1), "cpu")
    want = _call(deferred.deferred_composite, scene, view, p)
    scene.light_color = scene.light_color.clone()
    scene.light_color[5:] = float("nan")
    scene.light_pos = scene.light_pos.clone()
    scene.light_pos[3] = float("nan")
    got = _call(deferred.deferred_composite, scene, view, p)
    assert not bool(torch.isnan(got).any())
    assert torch.equal(got, want)


def test_cpu_tensors_take_the_plain_body(monkeypatch):
    """On the CPU the plain body runs once a call, and the kernel's counter
    stays where it was."""
    ran = []
    plain = deferred.deferred_composite_plain

    def counted(*args):
        ran.append(args)
        return plain(*args)

    monkeypatch.setattr(deferred, "deferred_composite_plain", counted)
    camera, scene, p = _cpu_inputs()
    before = deferred.DEFERRED_LAUNCHES.copy()
    _call(deferred.deferred_composite, scene, _view(camera, 10, (1,) * 5, "cpu"), p)
    assert len(ran) == 1
    assert deferred.DEFERRED_LAUNCHES == before


def test_other_devices_raise():
    camera, scene, p = _cpu_inputs()
    p["position"] = p["position"].to("meta")
    with pytest.raises(ValueError, match="no deferred composite"):
        _call(deferred.deferred_composite, scene, _view(camera, 1, (1,) * 5, "cpu"), p)


def test_the_source_declares_the_kernel_and_its_launch_check():
    """The kernel is a `__global__` of csrc/deferred.cu, built as the
    `deferred_shade` library; its launch returns cudaGetLastError; and the
    wrapper's ctypes mirror names DeferredArgs's fields in their order."""
    (source,) = deferred.SHADE.sources
    with open(source, encoding="utf-8") as f:
        src = f.read()
    assert re.search(r"__global__ void __launch_bounds__\(DEFERRED_THREADS\)\s*"
                     r"deferred_shade_kernel\(", src)
    launch = src[src.index('extern "C" int deferred_shade('):]
    assert "deferred_shade_kernel<<<" in launch
    assert "return static_cast<int>(cudaGetLastError());" in launch
    struct = src[src.index("struct DeferredArgs {"):]
    struct = struct[:struct.index("};")]
    fields = re.findall(r"(\w+)(?:\[\w+\])?;", struct)
    assert fields == [name for name, _ in deferred._Args._fields_]
    assert f"#define DEFERRED_MAX_LEVELS {deferred.MAX_LEVELS} " in src
    assert f"#define DEFERRED_MAX_CASCADES {deferred.MAX_CASCADES}\n" in src


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def frame_inputs(cuda_device):
    """The Sponza-scale scene's 1080p RASTERIZED frame (shadows on, so the
    four 4096² cascades are real), and the inputs its deferred pass got:
    (app, scene, planes), with a metal pixel, a sky pixel and rows 700-763
    of positions in every cascade (`plant_cascades`: the view's own pixels
    lie in cascades 0 and 1 only) planted."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    app = Application(1920, 1080, RenderGraphMode.RASTERIZED, device=cuda_device)
    app.create_scene(create_sponza_scale_scene)
    seen = []
    composite = deferred.deferred_composite

    def record(*args):
        seen.append(args)
        return composite(*args)

    deferred.deferred_composite = record
    try:
        app.run(1)
    finally:
        deferred.deferred_composite = composite
    assert len(seen) == 1
    scene, _, *rest = seen[0]
    names = ("position", "normal", "albedo", "pbr", "rt_reflections", "rt_shadows", "ssao",
             "shadow_map", "cascade_vp", "cascade_splits", "irradiance_map", "specular_map",
             "brdf_lut")
    p = {k: (v.clone() if isinstance(v, torch.Tensor) else list(v))
         for k, v in zip(names, rest)}
    scene = types.SimpleNamespace(**vars(scene))
    metals = torch.nonzero(scene.mat_rt_type == 1).flatten()
    if not len(metals):
        scene.mat_rt_type = scene.mat_rt_type.clone()
        scene.mat_rt_type[0] = 1
        metals = [0]
    p["pbr"][540, 960, 3] = float(metals[0])
    for name in ("position", "normal", "albedo", "pbr"):
        p[name][0, 0] = 1.0
    plant_cascades(p["position"][700:764], app.camera, p["cascade_splits"].cpu())
    reached = cascades_reached(p, _view(app.camera, 0, (1,) * 5, cuda_device))
    assert reached == set(range(p["shadow_map"].shape[0])), reached
    return app, scene, p


def _assert_close(got: torch.Tensor, want: torch.Tensor) -> float:
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    gap = (got - want).abs()[ok]
    excess = gap - RTOL * torch.clamp_min(want.abs()[ok], 1.0)
    assert float(excess.max()) <= 0.0, (
        f"worst excess {float(excess.max()):.3e}, "
        f"bit-equal share {float((got == want)[ok].float().mean()):.4f}")
    return float(gap.max())


@pytest.mark.cuda
@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "".join(map(str, c)))
def test_kernel_matches_plain_on_the_1080p_frame(frame_inputs, combo):
    app, scene, p = frame_inputs
    for num_lights in LIGHT_COUNTS:
        view = _view(app.camera, num_lights, combo, p["position"].device)
        before = deferred.DEFERRED_LAUNCHES.copy()
        got = _call(deferred.deferred_composite, scene, view, p)
        moved = dict(deferred.DEFERRED_LAUNCHES - before)
        assert moved == {"launches": 1, "pixels": 1920 * 1080}
        want = _call(deferred.deferred_composite_plain, scene, view, p)
        _assert_close(got, want)
        assert not bool(torch.isnan(got).any())


@pytest.mark.cuda
def test_kernel_drops_a_nan_light_beyond_num_lights(frame_inputs):
    app, scene, p = frame_inputs
    view = _view(app.camera, 3, (1, 1, 1, 0, 1), p["position"].device)
    want = _call(deferred.deferred_composite, scene, view, p)
    poisoned = types.SimpleNamespace(**vars(scene))
    poisoned.light_color = scene.light_color.clone()
    poisoned.light_color[5] = float("nan")
    poisoned.light_pos = scene.light_pos.clone()
    poisoned.light_pos[3:] = float("nan")
    got = _call(deferred.deferred_composite, poisoned, view, p)
    assert not bool(torch.isnan(got).any())
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_kernel_replays_from_a_captured_graph(frame_inputs):
    """A captured launch replays with the toggles, num_lights and eye that
    the view's tensors hold at replay time: bit for bit the eager launch."""
    app, scene, p = frame_inputs
    dev = p["position"].device
    view = _view(app.camera, 10, (1, 1, 1, 0, 1), dev)
    eager = _call(deferred.deferred_composite, scene, view, p)  # built and loaded first
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = _call(deferred.deferred_composite, scene, view, p)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    for changes in (dict(ibl_enabled=0, ssao_enabled=0, num_lights=3),
                    dict(shadows_enabled=0, cascade_debug=1, eye_pos=(-9.0, 2.5, 0.4)),
                    dict(raytracing_supported=0, shadows_enabled=1, cascade_debug=1)):
        for name, value in changes.items():
            getattr(view, name).copy_(torch.as_tensor(value, dtype=getattr(view, name).dtype))
        graph.replay()
        torch.cuda.synchronize()
        fresh = _call(deferred.deferred_composite, scene, view, p)
        assert torch.equal(out, fresh), changes
        _assert_close(out, _call(deferred.deferred_composite_plain, scene, view, p))
    assert not torch.equal(out, eager)


@pytest.mark.cuda
def test_cuda_tensors_never_run_the_plain_body(frame_inputs, monkeypatch):
    def refuse(*args):
        raise AssertionError("the plain body ran on CUDA tensors")

    monkeypatch.setattr(deferred, "deferred_composite_plain", refuse)
    app, scene, p = frame_inputs
    _call(deferred.deferred_composite, scene, _view(app.camera, 10, (1,) * 5, "cuda"), p)


@pytest.mark.cuda
def test_a_rasterized_frame_launches_the_kernel_once(frame_inputs):
    """One launch over every pixel a frame, in the host loop and in the
    device loop (the eager frame and the capture; the replays re-issue the
    captured launch)."""
    app = frame_inputs[0]
    before = deferred.DEFERRED_LAUNCHES.copy()
    app.run(2)
    assert dict(deferred.DEFERRED_LAUNCHES - before) == {"launches": 2,
                                                         "pixels": 2 * 1920 * 1080}
    app.run_on_device(4)
    assert app.graph.last_loop_form == "captured"
    assert deferred.DEFERRED_LAUNCHES["launches"] - before["launches"] == 4


def test_the_launch_block_holds_every_input(monkeypatch):
    """The CUDA wrapper's argument block, filled from CPU tensors with the
    library replaced by a recorder: every pointer is its tensor's (the view's
    fields and the tables read in place, where they are contiguous and of
    the kernel's type), the sizes are the inputs', the specular levels in
    order, and a launch is counted."""
    camera, scene, p = _cpu_inputs()
    view = _view(camera, 10, (1,) * 5, "cpu")
    calls = []

    class FakeLibrary:
        def deferred_args_size(self):
            return ctypes.sizeof(deferred._Args)

        def deferred_shade(self, address, stream):
            calls.append(deferred._Args.from_buffer_copy(
                (ctypes.c_char * ctypes.sizeof(deferred._Args)).from_address(address)))
            return 0

    monkeypatch.setattr(deferred.SHADE, "library", lambda: FakeLibrary())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(
        cuda_stream=0))
    before = deferred.DEFERRED_LAUNCHES.copy()
    out = _call(deferred.deferred_shade_cuda, scene, view, p)
    assert out.shape == (12, 20, 4)
    assert dict(deferred.DEFERRED_LAUNCHES - before) == {"launches": 1, "pixels": 240}
    (args,) = calls
    same = {"position": p["position"], "normal": p["normal"], "albedo": p["albedo"],
            "pbr": p["pbr"], "reflections": p["rt_reflections"],
            "rt_shadows": p["rt_shadows"], "ssao": p["ssao"], "out": out,
            "eye_pos": view.eye_pos, "sun_dir": view.sun_dir, "view_matrix": view.view,
            "cascade_vp": p["cascade_vp"], "cascade_splits": p["cascade_splits"],
            "shadow_map": p["shadow_map"], "irradiance": p["irradiance_map"],
            "brdf_lut": p["brdf_lut"],
            **{name: getattr(view, name) for name in ("num_lights", *TOGGLES)},
            **{name: getattr(scene, name) for name in (
                "mat_base_color", "mat_metallic", "mat_roughness", "mat_rt_type",
                "light_color", "light_pos", "light_dir", "light_type", "light_att",
                "light_spot")}}
    for name, tensor in same.items():
        assert getattr(args, name) == tensor.data_ptr(), name
    levels = p["specular_map"]
    assert list(args.specular)[:len(levels)] == [t.data_ptr() for t in levels]
    assert list(args.specular_size)[:len(levels)] == [32, 16, 8, 4, 2, 1]
    assert (args.rows, args.width, args.n_materials, args.n_lights, args.n_cascades,
            args.shadow_size, args.irradiance_size, args.lut_size, args.n_levels) == (
        12, 20, 6, 10, 4, 64, 8, 16, 6)


@pytest.mark.parametrize("wrong", ["float64_table", "strided_plane", "int64_toggle"])
def test_the_launch_block_refuses_a_copy(monkeypatch, wrong):
    """An input of another type or layout raises before a launch: the
    wrapper never makes a device copy of it."""
    camera, scene, p = _cpu_inputs()
    view = _view(camera, 10, (1,) * 5, "cpu")
    monkeypatch.setattr(deferred.SHADE, "library", lambda: pytest.fail("launched"))
    if wrong == "float64_table":
        scene.light_spot = scene.light_spot.double()
    elif wrong == "strided_plane":
        p["position"] = torch.cat([p["position"], p["position"]], 1)[:, ::2]
    else:
        view = view.replace(ssao_enabled=view.ssao_enabled.long())
    before = deferred.DEFERRED_LAUNCHES.copy()
    with pytest.raises(ValueError, match="dtype|contiguous"):
        _call(deferred.deferred_shade_cuda, scene, view, p)
    assert deferred.DEFERRED_LAUNCHES == before
