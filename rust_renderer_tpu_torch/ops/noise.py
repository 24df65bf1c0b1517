"""Hash-based value noise and fbm (the port of ``rust_renderer_tpu/ops/noise.py``;
utopian/shaders/marching_cubes/noise.glsl)."""

from __future__ import annotations

import torch


def _hash1(n: torch.Tensor) -> torch.Tensor:
    """fract(sin(n) * 43758.5453) value hash."""
    return torch.remainder(torch.sin(n) * 43758.5453, 1.0)


def noised(x: torch.Tensor) -> torch.Tensor:
    """Value noise in [-1, 1] at (..., 3) positions, quintic interpolation."""
    p = torch.floor(x)
    w = x - p
    u = w * w * w * (w * (w * 6.0 - 15.0) + 10.0)
    n = p[..., 0] + p[..., 1] * 317.0 + p[..., 2] * 157.0
    a, b, c, d, e, f, g, h = (_hash1(n + o) for o in
                              (0.0, 1.0, 317.0, 318.0, 157.0, 158.0, 474.0, 475.0))
    k0 = a
    k1 = b - a
    k2 = c - a
    k3 = e - a
    k4 = a - b - c + d
    k5 = a - c - e + g
    k6 = a - b - e + f
    k7 = -a + b + c - d + e - f - g + h
    ux, uy, uz = u[..., 0], u[..., 1], u[..., 2]
    val = (k0 + k1 * ux + k2 * uy + k3 * uz
           + k4 * ux * uy + k5 * uy * uz + k6 * uz * ux + k7 * ux * uy * uz)
    return -1.0 + 2.0 * val


def fbm(x: torch.Tensor, octaves: int = 5, lacunarity: float = 2.0,
        gain: float = 0.5) -> torch.Tensor:
    """Fractal Brownian motion over `noised`."""
    total = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    amp, freq = 0.5, 1.0
    for _ in range(octaves):
        total = total + amp * noised(x * freq)
        freq *= lacunarity
        amp *= gain
    return total
