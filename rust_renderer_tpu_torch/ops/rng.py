"""PCG random numbers, vectorized over pixel arrays, bit-exact with the JAX
package's ``ops/rng.py`` (utopian/shaders/include/random.glsl).

Every function takes and returns uint32 state held in an int64 tensor: torch
offers no uint32 ``+``, ``<<``, ``>>`` or ``^`` on the CPU, so the 32-bit
arithmetic runs in int64 and wraps with ``& 0xFFFFFFFF`` after each step, the
same way on every device. Products stay below 2^63 (state < 2^32 times
multipliers < 2^30).
"""

from __future__ import annotations

import math

import torch

MASK32 = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> uint32 bit pattern in int64 (wraps negatives)."""
    return x.to(torch.int64) & MASK32


def jenkins_hash(x: torch.Tensor) -> torch.Tensor:
    x = u32(x)
    x = (x + (x << 10)) & MASK32
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & MASK32
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & MASK32
    return x


def init_rng(px: torch.Tensor, py: torch.Tensor, width: int,
             frame: torch.Tensor) -> torch.Tensor:
    """Per-pixel seed: jenkins(dot(pixel, (1, res.x)) ^ jenkins(frame))."""
    seed = ((u32(px) + u32(py) * width) & MASK32) ^ jenkins_hash(frame)
    return jenkins_hash(seed)


def step_rng(state: torch.Tensor) -> torch.Tensor:
    return (state * 747796405 + 1) & MASK32


def random_float(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Advance state, return (new_state, uniform float32 in [0,1])."""
    state = step_rng(state)
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK32
    word = (word >> 22) ^ word
    # u32 -> f32 rounds to nearest; float32(4294967295.0) is 2^32, so the
    # division is an exact scaling.
    return state, word.to(torch.float32) / 4294967296.0


def random_vec2(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    state, a = random_float(state)
    state, b = random_float(state)
    return state, torch.stack([a, b], dim=-1)


def random_in_unit_sphere_fast(state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Loop-free uniform point in the unit ball: an isotropic Gaussian
    direction (Box-Muller) scaled by cbrt(u) — the JAX package's draw
    sequence (5 floats per call)."""
    state, u1 = random_float(state)
    state, u2 = random_float(state)
    state, u3 = random_float(state)
    state, u4 = random_float(state)
    state, u5 = random_float(state)
    r1 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u1, 1e-10)))
    g0 = r1 * torch.cos(2.0 * math.pi * u2)
    g1 = r1 * torch.sin(2.0 * math.pi * u2)
    r2 = torch.sqrt(-2.0 * torch.log(torch.clamp_min(u3, 1e-10)))
    g2 = r2 * torch.cos(2.0 * math.pi * u4)
    norm = torch.sqrt(torch.clamp_min(g0 * g0 + g1 * g1 + g2 * g2, 1e-20))
    radius = torch.pow(torch.clamp_min(u5, 1e-12), 1.0 / 3.0)
    scale = (radius / norm)[..., None]
    return state, torch.stack([g0, g1, g2], dim=-1) * scale
