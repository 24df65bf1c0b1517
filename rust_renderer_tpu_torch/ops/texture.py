"""Bindless texture-array sampling (the port of ``ops/texture.py``).

The reference samples with a linear, mirrored-repeat sampler and no mips
(utopian/src/texture.rs:36-98). Textures live in one (N, S, S, 4) uint8
tensor; uv (0,0) is the top-left texel origin, v grows downward in memory.
"""

from __future__ import annotations

import torch


def _mirror_repeat(coord: torch.Tensor, size: int) -> torch.Tensor:
    """MIRRORED_REPEAT addressing in texel space (float in, float out)."""
    period = 2.0 * size
    # The C remainder moved into [0, period), as jnp.mod computes it.
    m = torch.fmod(coord, period)
    m = torch.where(m < 0, m + period, m)
    return torch.where(m < size, m, period - 1.0 - m)


def _texels(textures: torch.Tensor, tex_id, y, x) -> torch.Tensor:
    """(…) integer coords -> (…, 4) float32 in [0, 1]."""
    return textures[tex_id, y, x].to(torch.float32) / 255.0


def sample_texture_nearest_mip0(textures: torch.Tensor, tex_id: torch.Tensor,
                                uv: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbor fetch, normalized [0,1] output. uv: (...,2)."""
    size = textures.shape[1]
    x = _mirror_repeat(uv[..., 0] * size, size).to(torch.int64).clamp(0, size - 1)
    y = _mirror_repeat(uv[..., 1] * size, size).to(torch.int64).clamp(0, size - 1)
    return _texels(textures, tex_id.to(torch.int64), y, x)


def sample_texture_bilinear(textures: torch.Tensor, tex_id: torch.Tensor,
                            uv: torch.Tensor) -> torch.Tensor:
    """Bilinear fetch with mirrored-repeat, normalized [0,1] output.

    textures: (N,S,S,4) uint8; tex_id: (...,) int; uv: (...,2) f32.
    Returns (...,4) f32. Mirroring is applied to the float sample coordinate
    and the coordinate is clamped to [0, S-1] before floor/frac; the +1
    neighbours clamp to the edge.
    """
    size = textures.shape[1]
    fx = torch.clamp(_mirror_repeat(uv[..., 0] * size - 0.5, size), 0.0, size - 1.0)
    fy = torch.clamp(_mirror_repeat(uv[..., 1] * size - 0.5, size), 0.0, size - 1.0)
    x0 = torch.floor(fx)
    y0 = torch.floor(fy)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]
    xi = x0.to(torch.int64)
    yi = y0.to(torch.int64)
    xi1 = (xi + 1).clamp_max(size - 1)
    yi1 = (yi + 1).clamp_max(size - 1)
    tid = tex_id.to(torch.int64)
    c00 = _texels(textures, tid, yi, xi)
    c10 = _texels(textures, tid, yi, xi1)
    c01 = _texels(textures, tid, yi1, xi)
    c11 = _texels(textures, tid, yi1, xi1)
    top = c00 * (1 - wx) + c10 * wx
    bot = c01 * (1 - wx) + c11 * wx
    return top * (1 - wy) + bot * wy
