"""Cubemap sampling and per-face directions (the port of
``rust_renderer_tpu/ops/cubemap.py``).

A cubemap is a (6, S, S, C) tensor in the Vulkan/GL face order 0 +X, 1 -X,
2 +Y, 3 -Y, 4 +Z, 5 -Z; a mip chain is a list of them. Sampling is bilinear
within the chosen face with clamp-to-edge, by direct indexing (the JAX
package's packed quad rows exist for the TPU's gathers).
"""

from __future__ import annotations

import torch

from rust_renderer_tpu_torch.ops.constants import device_constant

# Per-face basis: direction = normalize(forward + u*right + v*up), u, v in
# [-1, 1], v increasing down the image.
_FACE_FORWARD = ((1.0, 0.0, 0.0), (-1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                 (0.0, -1.0, 0.0), (0.0, 0.0, 1.0), (0.0, 0.0, -1.0))
_FACE_RIGHT = ((0.0, 0.0, -1.0), (0.0, 0.0, 1.0), (1.0, 0.0, 0.0),
               (1.0, 0.0, 0.0), (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0))
_FACE_UP = ((0.0, -1.0, 0.0), (0.0, -1.0, 0.0), (0.0, 0.0, 1.0),
            (0.0, 0.0, -1.0), (0.0, -1.0, 0.0), (0.0, -1.0, 0.0))


def face_directions(face: int, size: int, *, device) -> torch.Tensor:
    """(S, S, 3) unit directions through the texel centers of one face."""
    ts = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(ts, ts, indexing="ij")
    vec = lambda t: torch.tensor(t, dtype=torch.float32, device=device)
    d = vec(_FACE_FORWARD[face]) + u[..., None] * vec(_FACE_RIGHT[face]) \
        + v[..., None] * vec(_FACE_UP[face])
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def cube_directions(size: int, device) -> torch.Tensor:
    """(6, S, S, 3): face_directions of all six faces."""
    return torch.stack([face_directions(f, size, device=device) for f in range(6)])


def direction_to_face_uv(d: torch.Tensor):
    """Direction (..., 3) -> (face int64, u, v) with u, v in [0, 1]."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(
        is_x, torch.where(x > 0, 0, 1),
        torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    major = torch.where(is_x, ax, torch.where(is_y, ay, az))
    major = torch.clamp_min(major, 1e-12)
    u = torch.where(is_x, torch.where(x > 0, -z, z),
                    torch.where(is_y, x, torch.where(z > 0, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
    u = u / major
    v = v / major
    return face, u * 0.5 + 0.5, v * 0.5 + 0.5


def _bilinear(texels: torch.Tensor, offset, size, face, u, v) -> torch.Tensor:
    """Clamp-to-edge bilinear tap at (face, u, v) of a level of `size`
    texels a side stored from row `offset` of `texels` (N, C); `offset` and
    `size` may vary per sample. The sample point is clamped to [0, S-1] in
    texel space before floor / frac."""
    # A size given as an int is made on the device (a host copy would stall
    # the stream and cannot be captured into a CUDA graph).
    as_device = lambda dtype: (size.to(dtype) if torch.is_tensor(size)
                               else torch.full((), size, dtype=dtype, device=u.device))
    fsize = as_device(torch.float32)
    fx = torch.minimum(torch.clamp_min(u * fsize - 0.5, 0.0), fsize - 1.0)
    fy = torch.minimum(torch.clamp_min(v * fsize - 0.5, 0.0), fsize - 1.0)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    size = as_device(torch.int64)
    x0, y0 = x0.to(torch.int64), y0.to(torch.int64)
    x1, y1 = torch.minimum(x0 + 1, size - 1), torch.minimum(y0 + 1, size - 1)
    base = offset + face * size * size
    c00, c10 = texels[base + y0 * size + x0], texels[base + y0 * size + x1]
    c01, c11 = texels[base + y1 * size + x0], texels[base + y1 * size + x1]
    top = c00 * (1 - wx) + c10 * wx
    bot = c01 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy


def sample_cubemap(cube: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Bilinear sample (within the chosen face) of a (6,S,S,C) cubemap."""
    face, u, v = direction_to_face_uv(d)
    return _bilinear(cube.reshape(-1, cube.shape[-1]), 0, cube.shape[1], face, u, v)


def sample_cubemap_lod(chain: list[torch.Tensor], d: torch.Tensor, lod) -> torch.Tensor:
    """Trilinear-across-levels sample of a mip chain (textureLod): two
    bilinear taps, of the levels below and above `lod`, from one table."""
    n_levels = len(chain)
    dev = d.device
    lod = torch.clamp(lod, 0.0, n_levels - 1)
    lo = torch.floor(lod).to(torch.int64)
    hi = (lo + 1).clamp_max(n_levels - 1)
    frac = (lod - lo.to(torch.float32))[..., None]
    face, u, v = direction_to_face_uv(d)
    texels = torch.cat([c.reshape(-1, c.shape[-1]) for c in chain])
    sizes = device_constant(tuple(c.shape[1] for c in chain), dev, torch.int64)
    offsets = torch.cumsum(6 * sizes * sizes, 0) - 6 * sizes * sizes
    out_lo = _bilinear(texels, offsets[lo], sizes[lo], face, u, v)
    out_hi = _bilinear(texels, offsets[hi], sizes[hi], face, u, v)
    return out_lo * (1 - frac) + out_hi * frac
