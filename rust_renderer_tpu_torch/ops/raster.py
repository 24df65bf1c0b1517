"""Software rasterization: vertex transform, near clipping and visibility
(the port of ``rust_renderer_tpu/ops/raster.py``).

- Depth test LESS_OR_EQUAL, no blending, no backface culling (the reference's
  pipeline state, pipeline.rs:286-310).
- Near-plane clipping is geometric (Sutherland-Hodgman against clip z >= 0,
  up to 2 sub-triangles per triangle in a fixed 2T buffer). Clipped vertices
  carry barycentrics of their ORIGINAL triangle, so the visibility buffer
  reports original triangle ids and original-triangle barycentrics.

`rasterize` / `rasterize_depth` dispatch on the device of their inputs:
CUDA tensors launch kernels K5 / K4 (``ops/raster_binned.py``) at every
size; CPU tensors take the brute path below, as the JAX package does on its
CPU, or with method="binned" the kernels' plain versions. Any other device
raises, and so does method="brute" on CUDA tensors.

The brute path computes the JAX package's chunked fold (chunks of 64
triangles; the first triangle of a chunk keeps a depth tie, a later chunk
takes it) as one reduction: each pixel keeps the candidate of least
(z, later chunk, earlier slot). Only the pixels of each triangle's bounding
box, widened by one pixel, are tested; a pixel further out cannot pass the
edge test (rounding moves an edge by ~1e-7 of the screen coordinate).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_renderer_tpu_torch.ops.constants import device_constant

_CHUNK = 64
# (triangle, pixel) pairs evaluated at once by the brute path.
_PAIR_BUDGET = 1 << 21
INT64_MAX = torch.iinfo(torch.int64).max


class VisibilityBuffer(NamedTuple):
    depth: torch.Tensor  # (H, W) f32, NDC z in [0,1]; 1.0 = far/clear
    tri: torch.Tensor  # (H, W) i32 triangle id, -1 = none
    bary_u: torch.Tensor  # (H, W) f32 perspective-correct barycentric of v1
    bary_v: torch.Tensor  # (H, W) f32 of v2


def clear_visibility(height: int, width: int, device) -> VisibilityBuffer:
    return VisibilityBuffer(
        depth=torch.ones((height, width), dtype=torch.float32, device=device),
        tri=torch.full((height, width), -1, dtype=torch.int32, device=device),
        bary_u=torch.zeros((height, width), dtype=torch.float32, device=device),
        bary_v=torch.zeros((height, width), dtype=torch.float32, device=device),
    )


def merge_visibility(vis: VisibilityBuffer, init: VisibilityBuffer) -> VisibilityBuffer:
    """Depth-test `vis` against a previous buffer (the LOAD-op path the
    forward and MC draws use, graph.rs:189-196): covered and not farther."""
    covered = (vis.tri >= 0) & (vis.depth <= init.depth)
    return VisibilityBuffer(*(torch.where(covered, a, b) for a, b in zip(vis, init)))


def transform_vertices(positions: torch.Tensor, mvp: torch.Tensor) -> torch.Tensor:
    """(V,3) world -> (V,4) clip."""
    homo = torch.cat([positions, torch.ones_like(positions[:, :1])], dim=-1)
    return homo @ mvp.T


def clip_to_screen(clip: torch.Tensor, width: int, height: int):
    """Viewport transform with the reference's negative-viewport Y flip
    (render_utils.rs:4-13): NDC y=+1 maps to the TOP of the image.
    Returns (screen_xyz (V,3) with xy in pixels and z in [0,1], w (V,))."""
    w = clip[:, 3]
    safe_w = torch.where(w.abs() < 1e-9, 1e-9, w)
    ndc = clip[:, :3] / safe_w[:, None]
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * height
    return torch.stack([sx, sy, ndc[:, 2]], dim=-1), w


def clip_triangles_near(clip: torch.Tensor, indices: torch.Tensor):
    """Sutherland-Hodgman clip of every triangle against clip z >= 0.

    clip: (V,4); indices: (T,3). Returns tri_pos (2T,3,4), tri_bary (2T,3,2)
    (weights of v1 and v2 in the original triangle) and tri_orig (2T,) i32.
    Fully-outside and unused slots are collapsed to the origin.
    """
    dev = clip.device
    t_count = indices.shape[0]
    p = clip[indices.to(torch.int64)]  # (T, 3, 4)
    inside = p[..., 2] >= 0.0
    bary0 = device_constant(((0.0, 0.0), (1.0, 0.0), (0.0, 1.0)), dev)
    bary = bary0.expand(t_count, 3, 2)

    def isect(a_pos, a_bar, b_pos, b_bar):
        za, zb = a_pos[..., 2], b_pos[..., 2]
        t = za / torch.where((za - zb).abs() < 1e-12, 1e-12, za - zb)
        t = t[..., None]
        return a_pos + (b_pos - a_pos) * t, a_bar + (b_bar - a_bar) * t

    # Rotate each triangle so that A, B are the kept pair (2 inside) or A is
    # the kept vertex (1 inside).
    n_inside = inside.sum(-1)
    rot_sel = torch.zeros(t_count, dtype=torch.int64, device=dev)
    for r in range(3):
        is_in = inside[:, r]
        rot_sel = torch.where((n_inside == 1) & is_in, r, rot_sel)
        rot_sel = torch.where((n_inside == 2) & ~is_in, (r + 1) % 3, rot_sel)
    rows = torch.arange(t_count, device=dev)

    def sel(a, k):
        return torch.stack([a[:, (r + k) % 3] for r in range(3)])[rot_sel, rows]

    pa, pb, pc = sel(p, 0), sel(p, 1), sel(p, 2)
    ba, bb, bc = sel(bary, 0), sel(bary, 1), sel(bary, 2)
    pab, bab = isect(pa, ba, pb, bb)
    pac, bac = isect(pa, ba, pc, bc)
    pbc, bbc = isect(pb, bb, pc, bc)

    one = (n_inside == 1)[:, None]
    two = (n_inside == 2)[:, None]
    valid1 = (n_inside >= 1)[:, None, None]
    valid2 = two[:, :, None]
    t1_p = torch.stack([pa, torch.where(one, pab, pb),
                        torch.where(one, pac, torch.where(two, pbc, pc))], 1)
    t1_b = torch.stack([ba, torch.where(one, bab, bb),
                        torch.where(one, bac, torch.where(two, bbc, bc))], 1)
    t2_p = torch.stack([pa, pbc, pac], 1)
    t2_b = torch.stack([ba, bbc, bac], 1)
    tri_pos = torch.cat([torch.where(valid1, t1_p, 0.0), torch.where(valid2, t2_p, 0.0)])
    tri_bary = torch.cat([t1_b, t2_b])
    orig = torch.arange(t_count, dtype=torch.int32, device=dev)
    return tri_pos, tri_bary, torch.cat([orig, orig])


def float_order_key(z: torch.Tensor) -> torch.Tensor:
    """int64 keys ordered like the float32 values z (no NaN); -0.0 and 0.0
    get the same key, as they compare equal."""
    bits = (z + 0.0).contiguous().view(torch.int32).to(torch.int64)
    return torch.where(bits < 0, -(bits & 0x7FFFFFFF), bits)


def pixel_pairs(x0, x1, y0, y1, budget: int):
    """Every (row, pixel) pair of the inclusive pixel boxes
    [x0, x1] x [y0, y1] (int64 (R,) each; empty where x1 < x0 or y1 < y0),
    in groups of about `budget` pairs. Yields (row, px, py) int64 tensors."""
    bw = (x1 - x0 + 1).clamp_min(0)
    area = bw * (y1 - y0 + 1).clamp_min(0)
    rows = torch.nonzero(area > 0).squeeze(1)
    if rows.numel() == 0:
        return
    area = area[rows]
    ends = torch.cumsum(area, 0).cpu()
    group_start, done = 0, 0
    while group_start < rows.numel():
        # Rows up to the one that crosses done + budget (at least one row).
        stop = int(torch.searchsorted(ends, done + budget, right=True))
        stop = max(stop, group_start + 1)
        r = rows[group_start:stop]
        a = area[group_start:stop]
        n = int(ends[stop - 1]) - done
        rid = torch.repeat_interleave(r, a, output_size=n)
        first = torch.repeat_interleave(torch.cumsum(a, 0) - a, a, output_size=n)
        local = torch.arange(n, device=r.device) - first
        w = bw[rid]
        yield rid, x0[rid] + local % w, y0[rid] + local // w
        group_start, done = stop, int(ends[stop - 1])


def pixel_box(xs, ys, valid, width: int, height: int):
    """Pixel columns / rows whose centers can lie inside triangles with
    screen vertices xs, ys (..., 3): the bounding box widened by one pixel,
    clamped to the screen; empty where not valid."""
    lo = lambda v, n: torch.floor(v.clamp(-4.0, n + 4.0)).to(torch.int64) - 1
    hi = lambda v, n: torch.floor(v.clamp(-4.0, n + 4.0)).to(torch.int64) + 1
    x0 = lo(xs.amin(-1), width).clamp_min(0)
    x1 = torch.where(valid, hi(xs.amax(-1), width).clamp_max(width - 1), -1)
    y0 = lo(ys.amin(-1), height).clamp_min(0)
    y1 = torch.where(valid, hi(ys.amax(-1), height).clamp_max(height - 1), -1)
    return x0, x1, y0, y1


def rasterize_brute(clip, indices, width: int, height: int,
                    init: VisibilityBuffer | None = None,
                    chunk: int = _CHUNK) -> VisibilityBuffer:
    """The JAX package's brute path (ops/raster.py:199-293): per pixel the
    nearest triangle, ties resolved as its 64-triangle chunk fold does."""
    dev = clip.device
    if init is None:
        init = clear_visibility(height, width, dev)
    if indices.shape[0] == 0:
        return init
    tri_pos, tri_bary, tri_orig = clip_triangles_near(clip, indices)
    t2 = tri_pos.shape[0]
    screen, w = clip_to_screen(tri_pos.reshape(-1, 4), width, height)
    s = screen.reshape(t2, 3, 3)
    wv = w.reshape(t2, 3)
    x, y, z = s[..., 0], s[..., 1], s[..., 2]
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    valid = (wv > 1e-6).all(-1) & (area.abs() > 1e-12)
    inv_area = torch.where(valid, 1.0 / torch.where(area.abs() < 1e-12, 1.0, area), 0.0)
    n_chunks = max((t2 + chunk - 1) // chunk, 1)

    def barycentrics(slot, px, py):
        xs, ys = px.to(torch.float32) + 0.5, py.to(torch.float32) + 0.5
        x0, y0 = x[slot, 0], y[slot, 0]
        ia = inv_area[slot]
        l1 = ((xs - x0) * (y[slot, 2] - y0) - (x[slot, 2] - x0) * (ys - y0)) * ia
        l2 = ((x[slot, 1] - x0) * (ys - y0) - (xs - x0) * (y[slot, 1] - y0)) * ia
        l0 = 1.0 - l1 - l2
        zz = l0 * z[slot, 0] + l1 * z[slot, 1] + l2 * z[slot, 2]
        return l0, l1, l2, zz

    key = torch.full((height * width,), INT64_MAX, dtype=torch.int64, device=dev)
    for slot, px, py in pixel_pairs(*pixel_box(x, y, valid, width, height), _PAIR_BUDGET):
        l0, l1, l2, zz = barycentrics(slot, px, py)
        inside = (l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0) & torch.isfinite(zz)
        order = (n_chunks - 1 - slot // chunk) * chunk + slot % chunk
        k = torch.where(inside, (float_order_key(zz) << 32) | order, INT64_MAX)
        key.scatter_reduce_(0, py * width + px, k, "amin")

    pix = torch.nonzero(key != INT64_MAX).squeeze(1)
    order = key[pix] & 0xFFFFFFFF
    slot = (n_chunks - 1 - order // chunk) * chunk + order % chunk
    py, px = pix // width, pix % width
    l0, l1, l2, zz = barycentrics(slot, px, py)
    iw = 1.0 / torch.clamp_min(wv[slot], 1e-9)
    denom = l0 * iw[:, 0] + l1 * iw[:, 1] + l2 * iw[:, 2]
    denom = torch.where(denom.abs() < 1e-12, 1.0, denom)
    lp0 = l0 * iw[:, 0] / denom
    lp1 = l1 * iw[:, 1] / denom
    lp2 = l2 * iw[:, 2] / denom
    b = tri_bary[slot]
    pu = lp0 * b[:, 0, 0] + lp1 * b[:, 1, 0] + lp2 * b[:, 2, 0]
    pv = lp0 * b[:, 0, 1] + lp1 * b[:, 1, 1] + lp2 * b[:, 2, 1]

    def plane(values, fill, dtype):
        out = torch.full((height * width,), fill, dtype=dtype, device=dev)
        out[pix] = values.to(dtype)
        return out.reshape(height, width)

    found = VisibilityBuffer(
        depth=plane(zz, 1.0, torch.float32), tri=plane(tri_orig[slot], -1, torch.int32),
        bary_u=plane(pu, 0.0, torch.float32), bary_v=plane(pv, 0.0, torch.float32))
    return merge_visibility(found, init)


def _binned(device, method: str) -> bool:
    """True for the binned path (K4 / K5, or their plain versions on CPU
    tensors), False for the brute path."""
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no rasterizer for device {device}")
    if method not in ("auto", "binned", "brute"):
        raise ValueError(f"unknown rasterizer method {method!r}")
    if device.type == "cuda" and method == "brute":
        raise ValueError("the brute path is for CPU tensors; CUDA tensors launch K4 / K5")
    return device.type == "cuda" or method == "binned"


def rasterize(clip, indices, width: int, height: int, chunk: int = _CHUNK,
              init: VisibilityBuffer | None = None, method: str = "auto") -> VisibilityBuffer:
    """Rasterize triangles into a visibility buffer.

    clip: (V,4) clip-space vertices; indices: (T,3). `init` is a previous
    buffer to depth-test against (the LOAD-op path). CUDA tensors launch
    K5; CPU tensors take the brute path (its triangles folded `chunk` at a
    time, as in the JAX package), or K5's plain version with
    method="binned"."""
    if _binned(clip.device, method):
        from rust_renderer_tpu_torch.ops.raster_binned import rasterize_binned

        return rasterize_binned(clip, indices, width, height, init=init)
    return rasterize_brute(clip, indices, width, height, init=init, chunk=chunk)


def rasterize_depth(clip, indices, width: int, height: int, chunk: int = _CHUNK,
                    method: str = "auto") -> torch.Tensor:
    """Depth-only rasterization (shadow cascades, shadow.rs:111-131): min z,
    clear 1.0. CUDA tensors launch K4; CPU tensors take the brute path, or
    K4's plain version with method="binned"."""
    if _binned(clip.device, method):
        from rust_renderer_tpu_torch.ops.raster_binned import rasterize_depth_binned

        return rasterize_depth_binned(clip, indices, width, height)
    return rasterize_brute(clip, indices, width, height, chunk=chunk).depth


def interpolate(vis: VisibilityBuffer, indices, attr, fill: float = 0.0) -> torch.Tensor:
    """Deferred attribute resolve: gather the visible triangle's vertices and
    blend with the barycentrics. attr: (V, K) -> (H, W, K)."""
    if indices.shape[0] == 0:
        return torch.full(vis.tri.shape + (attr.shape[-1],), fill, dtype=attr.dtype,
                          device=attr.device)
    ids = indices.to(torch.int64)[vis.tri.clamp_min(0).to(torch.int64)]  # (H, W, 3)
    u = vis.bary_u[..., None]
    v = vis.bary_v[..., None]
    out = attr[ids[..., 0]] * (1.0 - u - v) + attr[ids[..., 1]] * u + attr[ids[..., 2]] * v
    return torch.where((vis.tri >= 0)[..., None], out, fill)
