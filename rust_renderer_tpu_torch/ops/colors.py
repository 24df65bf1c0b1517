"""Color-space helpers (utopian/shaders/include/view.glsl:53-66)."""

from __future__ import annotations

import torch


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB OETF (view.glsl:53-66); elementwise."""
    return torch.where(
        linear < 0.0031308,
        linear * 12.92,
        1.055 * torch.pow(torch.clamp_min(linear, 1e-12), 1.0 / 2.4) - 0.055,
    )
