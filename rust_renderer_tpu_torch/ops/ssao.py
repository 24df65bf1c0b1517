"""Screen-space ambient occlusion (the port of ``rust_renderer_tpu/ops/ssao.py``).

ssao.frag's 32-sample hemisphere kernel, oriented by a TBN about the
view-space normal, with the smoothstep range check and strength 1.6; the
sky (position cleared to (1,1,1)) is unoccluded. Two forms:

- `ssao`, the exact one: each sample reads the view depth at its projected
  pixel;
- `ssao_stencil`, the one the SSAO pass uses: each sample's projected tap is
  snapped to the nearest of 8 directions x 6 log2-spaced rings of static
  pixel offsets (edge-clamped), exactly as the JAX package's stencil form
  does; the raster goldens of the reference are blessed against it. It
  takes, for CPU tensors, the plain body (`ssao_stencil_plain`, the eager
  tensor code the CPU tests hold the JAX package to) and, for CUDA tensors,
  the SSAO kernels (``csrc/ssao.cu``: the view-depth plane, then the same
  float32 operations in the same order, one thread a pixel), or raises.
  `SSAO_LAUNCHES` counts the kernels' launches and the pixels they shaded;
  nothing else changes it.

`ssao_blur` is the reference's box blur, which its graph never wires in
(renderers/ssao.rs:34-36); no pass calls it here either.

On a row band of the image (`band`, a parallel/tiles.py RowBand) the
stencil and the blur read rows beyond the band's edges: they gather the
plane they shift to full height and read it at the band's image rows, so
that the edge clamp (or wrap) holds only at the image's top and bottom.
"""

from __future__ import annotations

import collections
import ctypes

import numpy as np
import torch

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.rays import apply_rows, cross, dot

KERNEL_SIZE = 32
STRENGTH = 1.6
_DIRS = 8
_RINGS = (1, 2, 4, 8, 16, 32)

# The kernels' launches (the depth plane's and the occlusion's, two a call)
# and the pixels they shaded.
SSAO_LAUNCHES: collections.Counter = collections.Counter()  # "launches", "pixels"
# The SSAO kernels' library (no TPU kernel: XLA fused the JAX package's
# stencil form). Each function takes the SsaoArgs block and the stream.
SSAO = native.declare("ssao", ["ssao.cu"], {
    "ssao_depth": [ctypes.c_void_p] * 2,
    "ssao_occlusion": [ctypes.c_void_p] * 2,
    "ssao_args_size": [],
})


def _make_kernel(n: int = KERNEL_SIZE, seed: int = 17) -> np.ndarray:
    """Hemisphere (z >= 0) samples biased toward the center (the classic
    LearnOpenGL kernel the reference generated its constants from)."""
    rng = np.random.default_rng(seed)
    v = rng.uniform([-1, -1, 0], [1, 1, 1], (n, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0, 1, (n, 1))
    scale = 0.1 + 0.9 * (np.arange(n) / n) ** 2
    return (v * scale[:, None]).astype(np.float32)


_KERNEL = _make_kernel()


def shifted(img: torch.Tensor, dy: int, dx: int, band=None) -> torch.Tensor:
    """img[y + dy, x + dx] with coordinates clamped to the image; with a
    RowBand, img is the whole image and y runs over the band's rows."""
    h, w = img.shape[:2]
    top, n = (0, h) if band is None else (band.offset, band.rows)
    rows = (torch.arange(top, top + n, device=img.device) + dy).clamp(0, h - 1)
    cols = (torch.arange(w, device=img.device) + dx).clamp(0, w - 1)
    return img[rows][:, cols]


def _to_ndc_xy(p, projection):
    clip = apply_rows(p, projection[:2])
    cw = apply_rows(p, projection[3:4])[..., 0]
    return clip / torch.clamp_min(cw.abs(), 1e-9)[..., None] * torch.sign(cw)[..., None]


def _view_frame(gbuffer_position, gbuffer_normal, view_matrix):
    """The sky mask, view-space positions, the TBN about the view-space
    normal (from the fixed random vector (1,1,0), ssao.frag:84-96) and the
    view depth image."""
    pos_world = gbuffer_position[..., :3]
    is_sky = (pos_world == 1.0).all(-1)
    pos_view = apply_rows(pos_world, view_matrix[:3])
    # inv_ex: the inverse without its singularity check, which would read
    # back to the host.
    normal_matrix = torch.linalg.inv_ex(view_matrix).inverse.T
    normal_view = apply_rows(gbuffer_normal[..., :3], normal_matrix[:3, :3])
    normal_view = normal_view / torch.clamp_min(
        torch.linalg.vector_norm(normal_view, dim=-1, keepdim=True), 1e-9)
    random_vec = device_constant((1.0, 1.0, 0.0), pos_world.device)
    t = random_vec - normal_view * dot(random_vec, normal_view)[..., None]
    t = t / torch.clamp_min(torch.linalg.vector_norm(t, dim=-1, keepdim=True), 1e-9)
    b = cross(t, normal_view)
    vz = apply_rows(pos_world, view_matrix[2:3])[..., 0]
    return is_sky, pos_view, normal_view, t, b, vz


def _sample_view(i: int, t, b, normal_view, pos_view, radius):
    k = _KERNEL[i]
    return (t * float(k[0]) + b * float(k[1]) + normal_view * float(k[2])) * radius + pos_view


def _occlusion(pos_view, sample_depth, sample_z, radius, bias):
    """One sample's occlusion, weighted by the smoothstep range check."""
    denom = torch.clamp_min((pos_view[..., 2] - sample_depth).abs(), 1e-9)
    range_check = torch.clamp(radius / denom, 0.0, 1.0)
    range_check = range_check * range_check * (3.0 - 2.0 * range_check)
    return (sample_depth >= sample_z + bias).to(torch.float32) * range_check


def ssao(gbuffer_position, gbuffer_normal, view_matrix, projection,
         radius: float, bias: float) -> torch.Tensor:
    """(H, W) occlusion in [0, 1] (1 = unoccluded), each sample's depth read
    at its projected pixel (ssao.frag:98-118, FLIP_UV_Y)."""
    h, w = gbuffer_position.shape[:2]
    is_sky, pos_view, normal_view, t, b, vz = _view_frame(gbuffer_position, gbuffer_normal,
                                                          view_matrix)
    vz_flat = vz.reshape(-1)
    occlusion = torch.zeros((h, w), dtype=torch.float32, device=vz.device)
    for i in range(KERNEL_SIZE):
        sample_view = _sample_view(i, t, b, normal_view, pos_view, radius)
        suv = _to_ndc_xy(sample_view, projection) * 0.5 + 0.5
        sx = (suv[..., 0] * w).to(torch.int32).clamp(0, w - 1)
        sy = ((1.0 - suv[..., 1]) * h).to(torch.int32).clamp(0, h - 1)
        sample_depth = vz_flat[(sy * w + sx).to(torch.int64)]
        occlusion = occlusion + _occlusion(pos_view, sample_depth, sample_view[..., 2],
                                           radius, bias)
    result = 1.0 - (occlusion / KERNEL_SIZE) * STRENGTH
    return torch.where(is_sky, 1.0, result)


def ssao_blur(occlusion: torch.Tensor, radius: int = 2, band=None) -> torch.Tensor:
    """(2r + 1)^2 box blur of the SSAO term, wrapping at the edges
    (ssao/blur.frag); of `band`'s rows of the image where given."""
    src = occlusion if band is None else band.gather(occlusion)
    acc = torch.zeros_like(src)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            acc = acc + torch.roll(torch.roll(src, dy, 0), dx, 1)
    out = acc / (2 * radius + 1) ** 2
    return out if band is None else out[band.offset:band.offset + band.rows]


def _stencil() -> tuple:
    """The static (dy, dx) pixel offsets: ring r along direction d (screen x
    right, y down) at index d * len(_RINGS) + r."""
    offsets = []
    for d in range(_DIRS):
        ang = 2.0 * np.pi * d / _DIRS
        ux, uy = np.cos(ang), np.sin(ang)
        offsets += [(int(round(uy * r)), int(round(ux * r))) for r in _RINGS]
    return tuple(offsets)


_STENCIL = _stencil()


def ssao_stencil(gbuffer_position, gbuffer_normal, view_matrix, projection,
                 radius, bias, band=None, *, enabled=None) -> torch.Tensor:
    """(H, W) occlusion in [0, 1] (1 = unoccluded); the planes and the
    result are `band`'s rows of the image where given. With `enabled` (the
    pass's int32 `ssao_enabled`), 1 wherever it is not 1. CPU tensors take
    the plain body, CUDA tensors the kernels."""
    dev = gbuffer_position.device
    args = (gbuffer_position, gbuffer_normal, view_matrix, projection, radius, bias, band)
    if dev.type == "cpu":
        return ssao_stencil_plain(*args, enabled=enabled)
    if dev.type == "cuda":
        return ssao_stencil_cuda(*args, enabled=enabled)
    raise ValueError(f"no SSAO stencil for device {dev}")


def ssao_stencil_plain(gbuffer_position, gbuffer_normal, view_matrix, projection,
                       radius, bias, band=None, *, enabled=None) -> torch.Tensor:
    """`ssao_stencil`'s plain version: the eager tensor code, the function
    the kernels compute."""
    h, w = gbuffer_position.shape[:2]
    is_sky, pos_view, normal_view, t, b, vz = _view_frame(gbuffer_position, gbuffer_normal,
                                                          view_matrix)
    if band is not None:
        h, vz = band.full_height, band.gather(vz)

    # The view depth shifted by every static offset: plane d * RINGS + r is
    # ring r along direction d.
    planes = torch.stack([shifted(vz, dy, dx, band) for dy, dx in _STENCIL])
    ndc_c = _to_ndc_xy(pos_view, projection)

    n_rings = len(_RINGS)
    log_r0 = float(np.log2(_RINGS[0]))
    occlusion = torch.zeros(is_sky.shape, dtype=torch.float32, device=vz.device)
    for i in range(KERNEL_SIZE):
        sample_view = _sample_view(i, t, b, normal_view, pos_view, radius)
        ndc = _to_ndc_xy(sample_view, projection)
        # Pixel offset from the pixel's own tap (screen y runs opposite to
        # ndc y), snapped to the nearest sector and log2 ring.
        fx = (ndc[..., 0] - ndc_c[..., 0]) * (0.5 * w)
        fy = (ndc_c[..., 1] - ndc[..., 1]) * (0.5 * h)
        ang = torch.atan2(fy, fx)
        sector = torch.remainder(torch.round(ang * (_DIRS / (2.0 * np.pi))).to(torch.int64),
                                 _DIRS)
        rad = torch.sqrt(fx * fx + fy * fy)
        ring = torch.clamp(torch.round(torch.log2(torch.clamp_min(rad, 1e-6)) - log_r0)
                           .to(torch.int64), 0, n_rings - 1)
        # A tap within half the innermost ring would read the pixel itself:
        # it counts as unoccluded.
        tiny = rad < 0.5 * _RINGS[0]
        sample_depth = planes.gather(0, (sector * n_rings + ring)[None])[0]
        occlusion = occlusion + torch.where(
            tiny, 0.0, _occlusion(pos_view, sample_depth, sample_view[..., 2], radius, bias))
    result = 1.0 - (occlusion / KERNEL_SIZE) * STRENGTH
    result = torch.where(is_sky, 1.0, result)
    return result if enabled is None else torch.where(enabled == 1, result, 1.0)


class _Args(ctypes.Structure):
    """csrc/ssao.cu's `SsaoArgs`, field for field."""

    _fields_ = [(name, ctypes.c_void_p) for name in (
        "position", "normal", "depth", "depth_full", "out", "view_matrix", "normal_matrix",
        "projection", "radius", "bias", "enabled")]
    _fields_ += [("kernel", ctypes.c_float * (KERNEL_SIZE * 3)),
                 ("offset", ctypes.c_int * (2 * _DIRS * len(_RINGS)))]
    _fields_ += [(name, ctypes.c_float) for name in (
        "half_w", "half_h", "sector_scale", "log_r0", "tiny", "strength", "inv_kernel_size")]
    _fields_ += [(name, ctypes.c_int) for name in (
        "nm_row", "nm_col", "rows", "width", "full_height", "row_offset")]


def _on_device(name: str, x, dtype, shape, dev) -> torch.Tensor:
    """x as the kernels read it in place: a contiguous tensor of `dtype` on
    `dev` of `shape`, or, for an int `shape`, of that many elements. A wrong
    type, device, shape or layout raises: nothing is copied."""
    if not isinstance(x, torch.Tensor):
        raise ValueError(f"the SSAO kernels read {name} from a tensor on {dev}, "
                         f"got {type(x).__name__}")
    if isinstance(shape, int):
        if x.numel() != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape} elements")
        shape = x.shape
    native.check(name, x, dtype, shape, dev)
    return x


def ssao_stencil_cuda(gbuffer_position, gbuffer_normal, view_matrix, projection,
                      radius, bias, band=None, *, enabled=None) -> torch.Tensor:
    """Launch the SSAO kernels (``csrc/ssao.cu``) on CUDA planes;
    `ssao_stencil`'s arguments, `radius`, `bias` and `enabled` as one-element
    device tensors. The view-depth plane of the rows, gathered to full height
    on a row band, then the occlusion. The matrices and uniforms are read
    from device memory, so a captured launch replays with the values they
    hold then."""
    dev = gbuffer_position.device
    f32 = torch.float32
    rows, width = gbuffer_position.shape[0], gbuffer_position.shape[1]
    full_height, row_offset = (rows, 0) if band is None else (band.full_height, band.offset)
    if band is not None and band.rows != rows:
        raise ValueError(f"the band has {band.rows} rows, the planes {rows}")
    if full_height * width >= 2 ** 31:
        raise ValueError(f"{full_height} x {width} pixels exceed one SSAO kernel launch")
    t = dict(
        position=_on_device("gbuffer_position", gbuffer_position, f32, (rows, width, 4), dev),
        normal=_on_device("gbuffer_normal", gbuffer_normal, f32, (rows, width, 4), dev),
        view_matrix=_on_device("view_matrix", view_matrix, f32, (4, 4), dev),
        projection=_on_device("projection", projection, f32, (4, 4), dev),
        radius=_on_device("radius", radius, f32, 1, dev),
        bias=_on_device("bias", bias, f32, 1, dev))
    if enabled is not None:
        t["enabled"] = _on_device("enabled", enabled, torch.int32, 1, dev)
    for name in ("position", "normal"):
        if t[name].data_ptr() % 16:
            raise ValueError(f"the SSAO kernels read gbuffer_{name} as float4: it must be "
                             "16-byte aligned")
    out = torch.empty((rows, width), dtype=f32, device=dev)
    if not rows or not width:
        return out
    lib = SSAO.library()
    if lib.ssao_args_size() != ctypes.sizeof(_Args):
        raise RuntimeError(f"csrc/ssao.cu's SsaoArgs holds {lib.ssao_args_size()} bytes, "
                           f"_Args {ctypes.sizeof(_Args)}")
    # The pass's normal matrix, bit for bit: inv_ex, the inverse without its
    # singularity check (which would read back to the host), read at the
    # transpose's strides.
    normal_matrix = torch.linalg.inv_ex(t["view_matrix"]).inverse.T
    depth = torch.empty((rows, width), dtype=f32, device=dev)
    args = _Args(**{name: x.data_ptr() for name, x in t.items()}, depth=depth.data_ptr(),
                 depth_full=depth.data_ptr(), out=out.data_ptr(),
                 normal_matrix=normal_matrix.data_ptr(), nm_row=normal_matrix.stride(0),
                 nm_col=normal_matrix.stride(1), half_w=0.5 * width,
                 half_h=0.5 * full_height, sector_scale=_DIRS / (2.0 * np.pi),
                 log_r0=float(np.log2(_RINGS[0])), tiny=0.5 * _RINGS[0], strength=STRENGTH,
                 inv_kernel_size=1.0 / KERNEL_SIZE, rows=rows, width=width,
                 full_height=full_height, row_offset=row_offset)
    args.kernel[:] = [float(k) for k in _KERNEL.reshape(-1)]
    args.offset[:] = [v for tap in _STENCIL for v in tap]
    SSAO.launch("ssao_depth", "the SSAO depth kernel", dev, ctypes.addressof(args))
    SSAO_LAUNCHES["launches"] += 1
    if band is not None:
        full = band.gather(depth)
        args.depth_full = _on_device("the gathered depth plane", full, f32,
                                     (full_height, width), dev).data_ptr()
    SSAO.launch("ssao_occlusion", "the SSAO occlusion kernel", dev, ctypes.addressof(args))
    SSAO_LAUNCHES["launches"] += 1
    SSAO_LAUNCHES["pixels"] += rows * width
    return out
