"""Color-space helpers (utopian/shaders/include/view.glsl:47-66)."""

from __future__ import annotations

import torch


def linear_to_srgb(linear: torch.Tensor) -> torch.Tensor:
    """Piecewise sRGB OETF (view.glsl:53-66); elementwise."""
    return torch.where(
        linear < 0.0031308,
        linear * 12.92,
        1.055 * torch.pow(torch.clamp_min(linear, 1e-12), 1.0 / 2.4) - 0.055,
    )


def srgb_to_linear(srgb: torch.Tensor) -> torch.Tensor:
    """The inverse OETF, exact (the reference decodes gbuffer albedo with
    pow 2.2, deferred.frag:60; this form is for texture decode)."""
    return torch.where(
        srgb < 0.04045,
        srgb / 12.92,
        torch.pow(torch.clamp_min((srgb + 0.055) / 1.055, 1e-12), 2.4),
    )


def luminance(rgb: torch.Tensor) -> torch.Tensor:
    """BT.709 luminance (view.glsl:47-51). rgb: (..., 3) -> (...)."""
    return rgb[..., 0] * 0.2126 + rgb[..., 1] * 0.7152 + rgb[..., 2] * 0.0722
