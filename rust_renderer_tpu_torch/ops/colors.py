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


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """BT.709 luminance (view.glsl:47-51). rgb: (..., 3) -> (...)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722
