"""FXAA 3.11-style antialiasing (the port of ``rust_renderer_tpu/ops/fxaa.py``;
utopian/shaders/include/fxaa.glsl after Simon Rodriguez's write-up).

Luma edge detection against relative and absolute thresholds, horizontal /
vertical edge classification, the edge-end walk with the quality step table
(taken as a first-hit scan over probes at the walk's fixed distances), the
edge-center offset and subpixel blending. Every probe is an edge-clamped
neighbor read (`ops/ssao.py::shifted`). The present pass's settings
(enabled, debug, threshold 0.45, renderers/present.rs:13-31) are arguments.
On a row band of the image (`band`, a parallel/tiles.py RowBand) the probes
read the whole image, gathered once, at the band's image rows.
"""

from __future__ import annotations

import torch

from rust_renderer_tpu_torch.ops.colors import luminance
from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.ssao import shifted

EDGE_THRESHOLD_MIN = 0.0312
ITERATIONS = 7
QUALITY = (1.0, 1.0, 1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0)
SUBPIXEL_QUALITY = 0.75

# Probe k sits DISTS[k] pixels along the edge.
_DISTS = [1.0]
for _i in range(1, ITERATIONS):
    _DISTS.append(_DISTS[-1] + QUALITY[min(_i, len(QUALITY) - 1)])


def fxaa(color: torch.Tensor, threshold: float = 0.45, enabled=1, debug=0,
         band=None) -> torch.Tensor:
    """color: (H, W, 3) in display space, or `band`'s rows of the image.
    debug=1 paints antialiased pixels red (horizontal edge) or green
    (vertical edge) (fxaa.glsl:247-258)."""
    full = color if band is None else band.gather(color)
    luma = luminance(color)
    full_luma = luma if band is None else luminance(full)
    sh = lambda dy, dx: shifted(full_luma, dy, dx, band)
    l_c, l_d, l_u, l_l, l_r = luma, sh(1, 0), sh(-1, 0), sh(0, -1), sh(0, 1)
    l_min = torch.minimum(l_c, torch.minimum(torch.minimum(l_d, l_u), torch.minimum(l_l, l_r)))
    l_max = torch.maximum(l_c, torch.maximum(torch.maximum(l_d, l_u), torch.maximum(l_l, l_r)))
    l_range = l_max - l_min
    no_edge = l_range < torch.clamp_min(l_max * 0.125 * threshold, EDGE_THRESHOLD_MIN)

    l_dl, l_ur, l_ul, l_dr = sh(1, -1), sh(-1, 1), sh(-1, -1), sh(1, 1)
    l_down_up = l_d + l_u
    l_left_right = l_l + l_r
    l_left_corners = l_dl + l_ul
    l_down_corners = l_dl + l_dr
    l_right_corners = l_dr + l_ur
    l_up_corners = l_ur + l_ul
    edge_h = ((-2.0 * l_l + l_left_corners).abs() + (-2.0 * l_c + l_down_up).abs() * 2.0
              + (-2.0 * l_r + l_right_corners).abs())
    edge_v = ((-2.0 * l_u + l_up_corners).abs() + (-2.0 * l_c + l_left_right).abs() * 2.0
              + (-2.0 * l_d + l_down_corners).abs())
    is_horizontal = edge_h >= edge_v

    l1 = torch.where(is_horizontal, l_u, l_l)
    l2 = torch.where(is_horizontal, l_d, l_r)
    grad1, grad2 = l1 - l_c, l2 - l_c
    is_1_steepest = grad1.abs() >= grad2.abs()
    grad_scaled = 0.25 * torch.maximum(grad1.abs(), grad2.abs())
    l_local_avg = torch.where(is_1_steepest, 0.5 * (l1 + l_c), 0.5 * (l2 + l_c))
    s_pos = ~is_1_steepest  # the step goes toward +y / +x

    probes: dict[int, torch.Tensor] = {}

    def probe_int(d: int) -> torch.Tensor:
        # Luma d pixels along the edge, half a texel toward the steeper side.
        if d not in probes:
            ph = 0.5 * (sh(0, d) + torch.where(s_pos, sh(1, d), sh(-1, d)))
            pv = 0.5 * (sh(d, 0) + torch.where(s_pos, sh(d, 1), sh(d, -1)))
            probes[d] = torch.where(is_horizontal, ph, pv)
        return probes[d]

    def probe(dist: float, sign: int) -> torch.Tensor:
        if dist == int(dist):
            return probe_int(sign * int(dist))
        lo = int(dist - 0.5)
        return 0.5 * (probe_int(sign * lo) + probe_int(sign * (lo + 1)))

    # First probe past grad_scaled on each side (or the last probe).
    reached1 = torch.zeros_like(no_edge)
    reached2 = torch.zeros_like(no_edge)
    dist1 = torch.zeros_like(luma)
    dist2 = torch.zeros_like(luma)
    l_end1 = torch.zeros_like(luma)
    l_end2 = torch.zeros_like(luma)
    for dk in _DISTS:
        e1 = probe(dk, -1) - l_local_avg
        e2 = probe(dk, +1) - l_local_avg
        dist1 = torch.where(reached1, dist1, dk)
        dist2 = torch.where(reached2, dist2, dk)
        l_end1 = torch.where(reached1, l_end1, e1)
        l_end2 = torch.where(reached2, l_end2, e2)
        reached1 = reached1 | (e1.abs() >= grad_scaled)
        reached2 = reached2 | (e2.abs() >= grad_scaled)
    is_dir1 = dist1 < dist2
    dist_final = torch.minimum(dist1, dist2)
    edge_len = dist1 + dist2
    pixel_offset = -dist_final / torch.clamp_min(edge_len, 1e-9) + 0.5
    is_l_center_smaller = l_c < l_local_avg
    correct_variation = (torch.where(is_dir1, l_end1, l_end2) < 0.0) != is_l_center_smaller
    final_offset = torch.where(correct_variation, pixel_offset, 0.0)

    # Subpixel antialiasing.
    l_avg = (1.0 / 12.0) * (2.0 * (l_down_up + l_left_right) + l_left_corners
                            + l_right_corners)
    sub_off1 = torch.clamp((l_avg - l_c).abs() / torch.clamp_min(l_range, 1e-9), 0.0, 1.0)
    sub_off2 = (-2.0 * sub_off1 + 3.0) * sub_off1 * sub_off1
    final_offset = torch.maximum(final_offset, sub_off2 * sub_off2 * SUBPIXEL_QUALITY)

    # Resample final_offset texels across the edge: a two-texel lerp.
    shc = lambda dy, dx: shifted(full, dy, dx, band)
    s3 = s_pos[..., None]
    neighbor = torch.where(is_horizontal[..., None],
                           torch.where(s3, shc(1, 0), shc(-1, 0)),
                           torch.where(s3, shc(0, 1), shc(0, -1)))
    f3 = final_offset[..., None]
    aa = (1.0 - f3) * color + f3 * neighbor
    edge_dir_color = torch.where(is_horizontal[..., None],
                                 device_constant((1.0, 0.0, 0.0), color.device),
                                 device_constant((0.0, 1.0, 0.0), color.device))
    aa = torch.where(torch.as_tensor(debug, device=color.device) == 1, edge_dir_color, aa)
    use_aa = ~no_edge & (torch.as_tensor(enabled, device=color.device) == 1)
    return torch.where(use_aa[..., None], aa, color)
