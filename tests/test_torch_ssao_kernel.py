"""The SSAO kernels (``csrc/ssao.cu``) and their plain version,
``ops/ssao.py::ssao_stencil_plain``.

This file imports torch and the port only (jax only inside the one test
that holds the plain body to the JAX package, on the CPU), so that its card
tests run on a GPU machine without jax:

    python -m pytest tests/test_torch_ssao_kernel.py -q --noconftest -p no:cacheprovider

On the CPU, `ssao_stencil` runs the plain body without touching the
kernels' counter or their library; the CUDA wrapper's launch block reads
every input in place and refuses one of another type or layout.

Tests marked `cuda` skip where torch sees no GPU. On the card the kernels
and the plain version take the inputs of the Sponza-scale scene's 1080p
SSAO pass and must agree bit for bit: the kernel runs the plain version's
float32 operations in its order, and its taps snap to the same pixels.
"""

import ctypes
import re
import types

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.camera import Camera
from rust_renderer_tpu_torch.ops import ssao
from rust_renderer_tpu_torch.ops.rays import apply_rows

# The Sponza-scale scene's viewpoint (models/scenes.py::create_sponza_scale_scene).
VIEWPOINT, TARGET = (-10.28, 2.10, -0.18), (0.0, 0.5, 0.0)
RADIUS, BIAS = 0.3, 0.025  # renderers/passes.py::setup_ssao_pass's defaults


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the SSAO kernels need an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _cpu_inputs(height: int = 12, width: int = 20, seed: int = 5):
    """(position, normal, view, projection, radius, bias): a bumpy floor
    laid over the image's pixels (tests/test_torch_raster_ops.py's SSAO
    surface) seen from above, a row of sky pixels (position cleared to (1,
    1, 1)), the uniforms as the pass's 0-d tensors."""
    rng = np.random.default_rng(seed)
    camera = Camera([-6.0, 2.0, 1.0], [0.0, 0.5, 0.0], aspect_ratio=1.0, z_near=0.1,
                    z_far=100.0)
    xs, zs = np.meshgrid(np.linspace(-3, 3, width), np.linspace(-3, 3, height))
    ys = 0.3 * np.sin(2 * xs) * np.cos(3 * zs) + 0.02 * rng.normal(size=xs.shape)
    gy, gx = np.gradient(ys)
    n = np.stack([-gx * 10, np.ones_like(ys), -gy * 10], -1)
    one = np.ones_like(ys)[..., None]
    position = torch.tensor(np.concatenate([np.stack([xs, ys, zs], -1), one], -1),
                            dtype=torch.float32)
    normal = torch.tensor(np.concatenate([n / np.linalg.norm(n, axis=-1, keepdims=True), one],
                                         -1), dtype=torch.float32)
    position[0] = 1.0
    view = torch.tensor(np.asarray(camera.get_view(), np.float32))
    projection = torch.tensor(np.asarray(camera.get_projection(), np.float32))
    return [position, normal, view, projection, torch.tensor(RADIUS), torch.tensor(BIAS)]


class FakeBand:
    """A RowBand of `rows` rows at `offset` of a `full_height` image whose
    other rows' view depth is `full_depth`: `gather` returns that plane
    with the band's own rows as given (checked equal to it)."""

    def __init__(self, offset: int, rows: int, full_depth: torch.Tensor):
        self.offset, self.rows, self.full_height = offset, rows, full_depth.shape[0]
        self.full_depth = full_depth
        self.gathered = []

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        assert torch.equal(t, self.full_depth[self.offset:self.offset + self.rows])
        full = self.full_depth.clone()
        self.gathered.append(full)
        return full


def _view_depth(position, view):
    return apply_rows(position[..., :3], view[2:3])[..., 0]


def test_cpu_tensors_take_the_plain_body(monkeypatch):
    """On the CPU the plain body runs once a call; the kernels' library is
    never built and their counter stays where it was."""
    ran = []
    plain = ssao.ssao_stencil_plain

    def counted(*args, **kw):
        ran.append(args)
        return plain(*args, **kw)

    monkeypatch.setattr(ssao, "ssao_stencil_plain", counted)
    monkeypatch.setattr(ssao.SSAO, "library", lambda: pytest.fail("library built"))
    before = ssao.SSAO_LAUNCHES.copy()
    out = ssao.ssao_stencil(*_cpu_inputs(), enabled=torch.tensor(1, dtype=torch.int32))
    assert out.shape == (12, 20)
    assert len(ran) == 1
    assert ssao.SSAO_LAUNCHES == before


def test_other_devices_raise():
    args = _cpu_inputs()
    args[0] = args[0].to("meta")
    with pytest.raises(ValueError, match="no SSAO stencil"):
        ssao.ssao_stencil(*args)


@pytest.mark.parametrize("enabled", [0, 1, 2])
def test_the_plain_body_folds_the_pass_select(enabled):
    """`enabled` is the pass's where(ssao_enabled == 1, occlusion, 1)."""
    args = _cpu_inputs()
    occ = ssao.ssao_stencil_plain(*args)
    assert float(occ.min()) < 1.0
    got = ssao.ssao_stencil_plain(*args, enabled=torch.tensor(enabled, dtype=torch.int32))
    assert torch.equal(got, occ if enabled == 1 else torch.ones_like(occ))


@pytest.mark.parametrize("offset", [0, 4, 8])
def test_the_plain_body_on_a_band_is_those_rows(offset):
    """A row band's plain output is those rows of the whole image's: its
    taps read the gathered full-height plane, clamped at the image's edges."""
    args = _cpu_inputs()
    whole = ssao.ssao_stencil_plain(*args)
    band = FakeBand(offset, 4, _view_depth(args[0], args[2]))
    rows = slice(offset, offset + 4)
    got = ssao.ssao_stencil_plain(args[0][rows], args[1][rows], *args[2:], band=band)
    assert len(band.gathered) == 1
    assert torch.equal(got, whole[rows])


def test_the_plain_body_matches_jax():
    """The plain body against the JAX package's `ssao_stencil` on a 48x48
    bumpy floor (tests/test_torch_raster_ops.py's SSAO case), the same
    float32 inputs to both: 99.5% of pixels within 1e-5, that file's
    tolerance (taps snap to pixels, so a last-bit difference can move
    one). The JAX package is the CPU tests' reference: where torch sees a
    GPU (where JAX might take it too) the test skips."""
    if torch.cuda.is_available():
        pytest.skip("the JAX package is compared on the CPU only")
    jax_ssao = pytest.importorskip("rust_renderer_tpu.ops.ssao")
    import jax.numpy as jnp

    args = _cpu_inputs(48, 48, seed=0)
    want = np.asarray(jax_ssao.ssao_stencil(*(jnp.asarray(a.numpy()) for a in args)))
    got = ssao.ssao_stencil_plain(*args).numpy()
    assert want.min() < 0.95  # some occlusion
    assert (np.abs(got - want) <= 1e-5).mean() >= 0.995


def test_the_source_declares_the_kernels_and_their_launch_checks():
    """The kernels are `__global__`s of csrc/ssao.cu, built as the `ssao`
    library; each launch returns cudaGetLastError; the wrapper's ctypes
    mirror names SsaoArgs's fields in their order, and the compile-time
    sizes are the module's."""
    (source,) = ssao.SSAO.sources
    with open(source, encoding="utf-8") as f:
        src = f.read()
    for kernel, fn in (("ssao_depth_kernel", "ssao_depth"),
                       ("ssao_occlusion_kernel", "ssao_occlusion")):
        assert re.search(r"__global__ void __launch_bounds__\(SSAO_THREADS\)\s*"
                         + kernel + r"\(", src)
        launch = src[src.index(f'extern "C" int {fn}('):]
        launch = launch[:launch.index("\n}")]
        assert f"{kernel}<<<" in launch
        assert "return static_cast<int>(cudaGetLastError());" in launch
        assert fn in ssao.SSAO.functions
    struct = src[src.index("struct SsaoArgs {"):]
    struct = re.sub(r"//[^\n]*", "", struct[:struct.index("};")])
    fields = re.findall(r"(\w+)(?:\[[\w *]+\])?;", struct)
    assert fields == [name for name, _ in ssao._Args._fields_]
    assert f"#define SSAO_KERNEL_SIZE {ssao.KERNEL_SIZE}\n" in src
    assert f"#define SSAO_DIRS {ssao._DIRS}\n" in src
    assert f"#define SSAO_RINGS {len(ssao._RINGS)}\n" in src


class _Recorder:
    """The library, replaced: records each launch's argument block."""

    def __init__(self):
        self.calls = []

    def ssao_args_size(self):
        return ctypes.sizeof(ssao._Args)

    def _record(self, fn, address):
        block = ssao._Args.from_buffer_copy(
            (ctypes.c_char * ctypes.sizeof(ssao._Args)).from_address(address))
        # The normal matrix's storage as the launch saw it: the wrapper's
        # own tensor, freed after the call.
        self.normal_matrix = list((ctypes.c_float * 16).from_address(block.normal_matrix))
        self.calls.append((fn, block))
        return 0

    def ssao_depth(self, address, stream):
        return self._record("ssao_depth", address)

    def ssao_occlusion(self, address, stream):
        return self._record("ssao_occlusion", address)


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(ssao.SSAO, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: types.SimpleNamespace(
        cuda_stream=0))
    return lib


@pytest.mark.parametrize("banded", [False, True])
def test_the_launch_block_holds_every_input(recorder, banded):
    """The CUDA wrapper's argument block, filled from CPU tensors with the
    library replaced by a recorder: the depth kernel, then the occlusion
    kernel reading the depth plane (on a band, the gathered plane at the
    band's offset); every pointer its tensor's, read in place; the normal
    matrix at the strides of the pass's inv_ex(view).inverse.T; the sample
    table and stencil the module's; the Python scalars in float32; two
    launches and the band's pixels counted."""
    args = _cpu_inputs()
    position, normal, view, projection, radius, bias = args
    enabled = torch.tensor(1, dtype=torch.int32)
    band = None
    if banded:
        band = FakeBand(4, 4, _view_depth(position, view))
        # The recorder writes no depth: the band's rows read as their plane.
        band.gather = lambda t: band.gathered.append(band.full_depth) or band.full_depth
        position, normal = position[4:8].clone(), normal[4:8].clone()
    before = ssao.SSAO_LAUNCHES.copy()
    out = ssao.ssao_stencil_cuda(position, normal, view, projection, radius, bias, band,
                                 enabled=enabled)
    rows = position.shape[0]
    assert out.shape == (rows, 20)
    assert dict(ssao.SSAO_LAUNCHES - before) == {"launches": 2, "pixels": rows * 20}
    assert [fn for fn, _ in recorder.calls] == ["ssao_depth", "ssao_occlusion"]
    depth_args, a = (block for _, block in recorder.calls)
    same = {"position": position, "normal": normal, "out": out, "view_matrix": view,
            "projection": projection, "radius": radius, "bias": bias, "enabled": enabled}
    for name, tensor in same.items():
        assert getattr(a, name) == getattr(depth_args, name) == tensor.data_ptr(), name
    assert depth_args.depth_full == depth_args.depth == a.depth
    if banded:
        assert a.depth_full == band.full_depth.data_ptr()
        assert (a.rows, a.full_height, a.row_offset, a.half_h) == (4, 12, 4, 6.0)
    else:
        assert a.depth_full == a.depth
        assert (a.rows, a.full_height, a.row_offset, a.half_h) == (12, 12, 0, 6.0)
    assert (a.width, a.half_w, a.log_r0, a.tiny, a.inv_kernel_size) == (20, 10.0, 0.0, 0.5,
                                                                         0.03125)
    assert a.sector_scale == float(np.float32(8 / (2 * np.pi)))
    assert a.strength == float(np.float32(ssao.STRENGTH))
    assert np.array_equal(np.array(a.kernel, np.float32), ssao._KERNEL.reshape(-1))
    assert list(a.offset) == [v for tap in ssao._STENCIL for v in tap]
    # The normal matrix the block points at, read at its strides, is the
    # plain body's.
    want = torch.linalg.inv_ex(view).inverse.T
    storage = recorder.normal_matrix
    got = torch.tensor([[storage[r * a.nm_row + c * a.nm_col] for c in range(4)]
                        for r in range(4)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("wrong", ["float64_plane", "strided_plane", "short_plane",
                                   "float_radius", "int64_enabled", "strided_view"])
def test_the_launch_block_refuses_a_copy(recorder, wrong):
    """An input of another type, shape or layout raises before a launch: the
    wrapper never makes a device copy of it."""
    args = _cpu_inputs()
    enabled = torch.tensor(1, dtype=torch.int32)
    if wrong == "float64_plane":
        args[0] = args[0].double()
    elif wrong == "strided_plane":
        args[1] = torch.cat([args[1], args[1]], 1)[:, ::2]
    elif wrong == "short_plane":
        args[1] = args[1][:, :, :3]
    elif wrong == "float_radius":
        args[4] = RADIUS
    elif wrong == "int64_enabled":
        enabled = enabled.long()
    else:
        args[2] = args[2].T.contiguous().T
    before = ssao.SSAO_LAUNCHES.copy()
    with pytest.raises(ValueError, match="dtype|contiguous|shape|tensor"):
        ssao.ssao_stencil_cuda(*args, enabled=enabled)
    assert ssao.SSAO_LAUNCHES == before
    assert recorder.calls == []


# -- on the card ---------------------------------------------------------------


@pytest.fixture(scope="module")
def frame_inputs(cuda_device):
    """The Sponza-scale scene's 1080p RASTERIZED frame, and the inputs its
    SSAO pass got: (app, [position, normal, view, projection, radius, bias],
    enabled)."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    app = Application(1920, 1080, RenderGraphMode.RASTERIZED, device=cuda_device)
    app.create_scene(create_sponza_scale_scene)
    seen = []
    stencil = ssao.ssao_stencil

    def record(*args, **kw):
        seen.append((args, kw))
        return stencil(*args, **kw)

    ssao.ssao_stencil = record
    try:
        app.run(1)
    finally:
        ssao.ssao_stencil = stencil
    assert len(seen) == 1
    args, kw = seen[0]
    assert kw["band"] is None
    inputs = [a.clone() for a in args]
    return app, inputs, kw["enabled"].clone()


def _mismatch(got: torch.Tensor, want: torch.Tensor) -> str:
    off = got != want
    return (f"{int(off.sum())} of {off.numel()} pixels differ, largest "
            f"{float((got - want).abs().max()):.3e}")


@pytest.mark.cuda
@pytest.mark.parametrize("enabled", [None, 0, 1])
def test_kernel_is_bit_equal_to_plain_on_the_1080p_frame(frame_inputs, enabled):
    app, args, flag = frame_inputs
    if enabled is not None:
        flag = torch.full_like(flag, enabled)
    kw = {} if enabled is None else {"enabled": flag}
    before = ssao.SSAO_LAUNCHES.copy()
    got = ssao.ssao_stencil(*args, **kw)
    assert dict(ssao.SSAO_LAUNCHES - before) == {"launches": 2, "pixels": 1920 * 1080}
    want = ssao.ssao_stencil_plain(*args, **kw)
    assert torch.equal(got, want), _mismatch(got, want)
    if enabled != 0:
        assert float(got.min()) < 0.5 and float(got.max()) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 270, 810])
def test_a_band_is_those_rows_of_the_whole_image(frame_inputs, offset):
    """A 270-row band (the top, one inside, the bottom) reads the gathered
    full-height plane: its output is those rows of the whole image's, bit
    for bit, and its own depth plane is the plain expression's."""
    _, args, flag = frame_inputs
    whole = ssao.ssao_stencil(*args, enabled=flag)
    band = FakeBand(offset, 270, _view_depth(args[0], args[2]))
    rows = slice(offset, offset + 270)
    got = ssao.ssao_stencil(args[0][rows], args[1][rows], *args[2:], band=band, enabled=flag)
    assert len(band.gathered) == 1
    assert torch.equal(got, whole[rows]), _mismatch(got, whole[rows])


@pytest.mark.cuda
def test_kernel_replays_from_a_captured_graph(frame_inputs):
    """A captured call replays with the radius, bias, view matrix and
    `enabled` that their tensors hold at replay time: bit for bit a fresh
    eager call, and the plain body."""
    _, args, flag = frame_inputs
    args = [a.clone() for a in args]
    flag = flag.clone()
    dev = args[0].device
    eager = ssao.ssao_stencil(*args, enabled=flag)  # built and loaded first
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        with torch.cuda.graph(graph, stream=stream):
            out = ssao.ssao_stencil(*args, enabled=flag)
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    camera = Camera([-9.0, 2.5, 0.4], list(TARGET), aspect_ratio=1920 / 1080)
    moved_view = torch.tensor(np.asarray(camera.get_view(), np.float32))
    for change in ("radius", "view", "enabled"):
        if change == "radius":
            args[4].fill_(0.5)
            args[5].fill_(0.05)
        elif change == "view":
            args[2].copy_(moved_view)
        else:
            flag.fill_(0)
        graph.replay()
        torch.cuda.synchronize()
        fresh = ssao.ssao_stencil(*args, enabled=flag)
        assert torch.equal(out, fresh), change
        want = ssao.ssao_stencil_plain(*args, enabled=flag)
        assert torch.equal(out, want), (change, _mismatch(out, want))
    assert torch.equal(out, torch.ones_like(out))


@pytest.mark.cuda
def test_cuda_tensors_never_run_the_plain_body(frame_inputs, monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("the plain body ran on CUDA tensors")

    monkeypatch.setattr(ssao, "ssao_stencil_plain", refuse)
    _, args, flag = frame_inputs
    ssao.ssao_stencil(*args, enabled=flag)
    frame_inputs[0].run(1)


@pytest.mark.cuda
def test_a_rasterized_frame_launches_the_kernels_once(frame_inputs):
    """One call (the depth plane, then the occlusion) over every pixel a
    frame, in the host loop and in the device loop (the eager frame and the
    capture; the replays re-issue the captured launches)."""
    app = frame_inputs[0]
    before = ssao.SSAO_LAUNCHES.copy()
    app.run(2)
    assert dict(ssao.SSAO_LAUNCHES - before) == {"launches": 4, "pixels": 2 * 1920 * 1080}
    app.run_on_device(4)
    assert app.graph.last_loop_form == "captured"
    assert ssao.SSAO_LAUNCHES["launches"] - before["launches"] == 8
