"""Tile-binned rasterization: kernels K4 (depth) and K5 (visibility buffer),
and the plain PyTorch version of each (the port of
``rust_renderer_tpu/ops/raster_binned.py``).

1. `tri_rows`: clip and screen-transform the triangles and precompute per
   triangle three edge functions E_i(x, y) = A_i·x + B_i·y + C_i,
   sign-normalized so that inside means all E >= 0 for both windings (cull
   mode NONE), and the vertex depths. Invalid triangles become dead rows
   (zero gradients, C = -1: never inside).
2. `bin_triangles`: bin triangles to 32x256-pixel tiles by screen bounding
   box, in static shapes and with no read back to the host. Every clipped
   triangle emits SPAN_X x SPAN_Y candidate (tile, triangle) pairs; a pair
   the triangle does not touch, and every pair of a triangle spanning more
   tiles (which goes to a global list that every tile walks), gets the
   sentinel tile `nx * ny`, which sorts last. Pairs are sorted by tile with
   a stable sort, so each tile's segment lists its triangles by (span slot,
   triangle id). The table a kernel reads is [SPAN_X * SPAN_Y * 2T segment
   slots | 2T global slots], rows contiguous: (R, 16) f32 for depth,
   (R, 24) f32 for the visibility buffer. The global list's length is a
   device int32 (`Bins.g_count`), which the plan kernel turns into the
   kernels' `gmeta`.
3. A tile walks the global list in triangle-id order, then its own segment.
   K4 keeps the running minimum depth from a clear of 1.0; K5 keeps
   (depth, triangle, u, v) and takes a triangle where it is inside, z <=
   depth and z <= 1, so on equal depth the later triangle of the walk wins.

`rasterize_depth_binned` / `rasterize_binned` launch K4 / K5 on CUDA
tensors and take the plain versions on CPU tensors; any other device
raises. `K4_LAUNCHES` and `K5_LAUNCHES` count kernel launches; nothing else
changes them. K4 and K5 test each row only on its pixel box (`row_boxes`)
and take their work in items of at most `K4_ITEM_ROWS` rows of one tile
(`depth_plan`, `depth_plan_items`), so that a crowded tile is spread over
the card; K5 then decodes each pixel's least key, the key its plain
version reduces. On CUDA tensors `depth_plan` launches the plan kernel of
``csrc/raster_binned.cu``, which K4's and K5's wrappers call; it counts as
part of their launch.

The plain versions compute the same function over the same table without
tiles' pixel blocks: every table row is tested only on the pixels of its
triangle's bounding box widened by one pixel (and, for a segment row, inside
its tile), and the tile's fold becomes a reduction over pixels: K4's minimum
is exact in any order, and K5's in-order last-wins walk is the least
(z, later walk position) key.
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import NamedTuple

import torch

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.raster import (
    INT64_MAX, VisibilityBuffer, clear_visibility, clip_to_screen,
    clip_triangles_near, float_order_key, merge_visibility, pixel_box, pixel_pairs)
from rust_renderer_tpu_torch.ops.traversal import _check, nvcc_command

TILE_H = 32
TILE_W = 256
SPAN_X = 2  # tiles a triangle may span horizontally before going global
SPAN_Y = 4
DEPTH_STRIDE = 16  # f32 per depth row
VIS_STRIDE = 24  # f32 per visibility row
# K4's and K5's work item: at most this many rows of one tile
# (raster_binned.cu).
K4_ITEM_ROWS = 1024
_PAIR_BUDGET = 1 << 24

SOURCE = os.path.join(native.PACKAGE_DIR, "csrc", "raster_binned.cu")

K4_LAUNCHES = 0
K5_LAUNCHES = 0


class TriRows(NamedTuple):
    rows: torch.Tensor  # (2T, 16 or 24) f32
    tx0: torch.Tensor  # (2T,) i64 first tile column
    ty0: torch.Tensor  # (2T,) i64 first tile row
    span_w: torch.Tensor  # (2T,) tiles spanned horizontally
    span_h: torch.Tensor
    valid: torch.Tensor  # (2T,) bool: covers area and lies on screen
    is_global: torch.Tensor  # (2T,) bool
    box: tuple  # pixel bounding box (x0, x1, y0, y1), each (2T,) i64


class Bins(NamedTuple):
    """What K4 and K5 read, and where each row lies. The shapes depend only
    on the triangle count and the image size: R = (SPAN_X * SPAN_Y + 1) *
    2T rows, of which the walks read the segments [starts[t], starts[t] +
    counts[t]) and the global rows [g_base, g_base + g_count). Every other
    row (a sentinel pair, a global slot past g_count) is a dead row with an
    empty box."""

    table: torch.Tensor  # (R, stride) f32: [segment slots | global slots]
    starts: torch.Tensor  # (ny*nx,) i32 first segment row of each tile
    counts: torch.Tensor  # (ny*nx,) i32
    g_base: int  # first global slot, SPAN_X * SPAN_Y * 2T
    g_count: torch.Tensor  # () i32 on the table's device: the global list's rows
    nx: int
    ny: int
    row_tile: torch.Tensor  # (R,) i64 tile of a live segment row, -1 elsewhere
    row_box: tuple  # pixel bounding box of each row's triangle, (R,) i64 x4


def tri_rows(clip, indices, width: int, height: int, vis: bool = False) -> TriRows:
    """Per-triangle rows and tile boxes (raster_binned.py:54-139).

    Depth rows: [A0,B0,C0, A1,B1,C1, A2,B2,C2, z0,z1,z2, inv_abs_area, 0,0,0].
    Visibility rows add [iw0,iw1,iw2, b0u,b0v,b1u,b1v,b2u,b2v, orig_id, 0]
    after inv_abs_area, for perspective-correct original-triangle
    barycentrics."""
    tri_pos, tri_bary, tri_orig = clip_triangles_near(clip, indices)
    t2 = tri_pos.shape[0]
    screen, w = clip_to_screen(tri_pos.reshape(-1, 4), width, height)
    s = screen.reshape(t2, 3, 3)
    wv = w.reshape(t2, 3)
    x0, y0, z0 = s[:, 0, 0], s[:, 0, 1], s[:, 0, 2]
    x1, y1, z1 = s[:, 1, 0], s[:, 1, 1], s[:, 1, 2]
    x2, y2, z2 = s[:, 2, 0], s[:, 2, 1], s[:, 2, 2]

    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    valid = (wv > 1e-6).all(-1) & (area.abs() > 1e-12)
    sgn = torch.sign(area)
    inv_area = torch.where(valid, 1.0 / torch.where(area.abs() < 1e-12, 1.0, area), 0.0)

    def edge(xa, ya, xb, yb):
        # E(x,y) = (xb-xa)(y-ya) - (yb-ya)(x-xa), sign-normalized.
        return (-(yb - ya) * sgn, (xb - xa) * sgn,
                ((yb - ya) * xa - (xb - xa) * ya) * sgn)

    a0, b0, c0 = edge(x0, y0, x1, y1)
    a1, b1, c1 = edge(x1, y1, x2, y2)
    a2, b2, c2 = edge(x2, y2, x0, y0)
    zeros = torch.zeros_like(x0)
    cols = [a0, b0, c0, a1, b1, c1, a2, b2, c2, z0, z1, z2, inv_area.abs()]
    if vis:
        iw = 1.0 / torch.clamp_min(wv, 1e-9)
        cols += [iw[:, 0], iw[:, 1], iw[:, 2],
                 tri_bary[:, 0, 0], tri_bary[:, 0, 1], tri_bary[:, 1, 0],
                 tri_bary[:, 1, 1], tri_bary[:, 2, 0], tri_bary[:, 2, 1],
                 tri_orig.to(torch.float32), zeros]
    else:
        cols += [zeros, zeros, zeros]
    rows = torch.stack(cols, dim=-1)
    rows = torch.where(valid[:, None], rows, dead_row(rows.shape[1], rows.device))

    xs, ys = s[..., 0], s[..., 1]
    xmin, xmax = xs.amin(-1), xs.amax(-1)
    ymin, ymax = ys.amin(-1), ys.amax(-1)
    on_screen = (xmax >= 0) & (xmin < width) & (ymax >= 0) & (ymin < height)
    valid = valid & on_screen
    nx, ny = -(-width // TILE_W), -(-height // TILE_H)

    def tile(v, size, n):
        # floor, then clip: NaN corners belong to invalid rows only.
        v = torch.nan_to_num(v, nan=0.0).clamp(-1e9, 1e9)
        return torch.floor(v / size).to(torch.int64).clamp(0, n - 1)

    tx0, tx1 = tile(xmin, TILE_W, nx), tile(xmax, TILE_W, nx)
    ty0, ty1 = tile(ymin, TILE_H, ny), tile(ymax, TILE_H, ny)
    span_w = tx1 - tx0 + 1
    span_h = ty1 - ty0 + 1
    is_global = valid & ((span_w > SPAN_X) | (span_h > SPAN_Y))
    box = pixel_box(xs, ys, valid, width, height)
    return TriRows(rows, tx0, ty0, span_w, span_h, valid, is_global, box)


def dead_row(stride: int, device) -> torch.Tensor:
    """A row that is never inside: zero gradients, C = -1 (a visibility row
    also names triangle -1). One constant per (stride, device), shared:
    made on the device once, so a frame copies nothing from the host."""
    row = [0.0] * stride
    row[2] = row[5] = row[8] = -1.0
    if stride == VIS_STRIDE:
        row[22] = -1.0
    return device_constant(tuple(row), torch.device(device))


def bin_triangles(tr: TriRows, width: int, height: int) -> Bins:
    """(tile, triangle) pairs sorted by tile, per-tile segments and the
    global list (raster_binned.py:159-227, without the TPU's row packing),
    in static shapes and with no read back to the host. Nothing is dropped:
    the table has a slot for every pair and every global triangle."""
    dev = tr.rows.device
    t2 = tr.rows.shape[0]
    nx, ny = -(-width // TILE_W), -(-height // TILE_H)
    n_tiles = nx * ny
    g_base = SPAN_X * SPAN_Y * t2
    binned = tr.valid & ~tr.is_global
    tiles = []
    for s in range(SPAN_X * SPAN_Y):
        dy, dx = divmod(s, SPAN_X)
        take = binned & (dy < tr.span_h) & (dx < tr.span_w)
        tiles.append(torch.where(take, (tr.ty0 + dy) * nx + (tr.tx0 + dx), n_tiles))
    # Pair p is (span slot p // 2T, triangle p % 2T); the stable sort keeps
    # that order within a tile, and the sentinel pairs last.
    tile_ids, order = torch.sort(torch.cat(tiles), stable=True)
    grid = torch.arange(n_tiles, dtype=torch.int64, device=dev)
    starts = torch.searchsorted(tile_ids, grid, right=False)
    counts = torch.searchsorted(tile_ids, grid, right=True) - starts
    ids = torch.arange(t2, device=dev)
    # The global triangles compacted to the front, in triangle-id order.
    g_order = torch.argsort(torch.where(tr.is_global, ids, 2 * t2 + 1), stable=True)
    g_count = tr.is_global.sum(dtype=torch.int32)
    seg_live = tile_ids < n_tiles
    live = torch.cat([seg_live, ids < g_count])
    # A slot no walk reads takes row 2T, a dead row with an empty box.
    src = torch.where(live, torch.cat([order % t2, g_order]), t2)
    dead = dead_row(tr.rows.shape[1], dev)
    return Bins(
        table=torch.cat([tr.rows, dead[None]])[src],
        starts=starts.to(torch.int32), counts=counts.to(torch.int32),
        g_base=g_base, g_count=g_count, nx=nx, ny=ny,
        row_tile=torch.cat([torch.where(seg_live, tile_ids, -1), ids.new_full((t2,), -1)]),
        row_box=tuple(torch.cat([b, b.new_full((1,), empty)])[src]
                      for b, empty in zip(tr.box, (0, -1, 0, -1))),
    )


# -- the kernels ---------------------------------------------------------------


@functools.cache
def library() -> ctypes.CDLL:
    """Build (at first use) and bind K4, K5 and their plan kernel. Cached,
    as `traversal.library` is: every launch asks for its library, and
    building the nvcc command resolves nvcc on PATH."""
    lib = native.load_library("k45_raster_binned", [SOURCE], nvcc_command())
    # pointers in (the plan: counts, g_count; K4 and K5: table, the four box
    # columns, starts, counts, plan, gmeta), then ints, then the outputs (the
    # plan: itself and gmeta; K5: the key plane first) and the stream
    for fn, n_in, n_ints, n_out in ((lib.raster_plan, 2, 1, 2),
                                    (lib.k4_depth_binned, 9, 4, 1),
                                    (lib.k5_vis_binned, 9, 5, 5)):
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_in + [ctypes.c_int] * n_ints
                       + [ctypes.c_void_p] * (n_out + 1))
    return lib


def _check_bins(bins: Bins, width: int, height: int, kernel: str) -> None:
    """Raises on bins a K4 / K5 launch does not take (nothing is truncated)."""
    _check_plan(bins)
    if bins.nx != -(-width // TILE_W) or bins.ny != -(-height // TILE_H):
        raise ValueError("bins were made for another image size")
    if width * height >= 2 ** 31 or bins.table.shape[0] >= 2 ** 31:
        raise ValueError("image or table too large for int32 offsets")
    dev = bins.table.device
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    n_tiles = bins.nx * bins.ny
    _check("table", bins.table, torch.float32, (bins.table.shape[0], bins.table.shape[1]), dev)
    _check("starts", bins.starts, torch.int32, (n_tiles,), dev)
    _check("counts", bins.counts, torch.int32, (n_tiles,), dev)
    _check("g_count", bins.g_count, torch.int32, (), dev)
    for name, box in zip(("x0", "x1", "y0", "y1"), bins.row_box):
        _check(f"row_box {name}", box, torch.int64, (bins.table.shape[0],), dev)


class DepthPlan(NamedTuple):
    """The work of K4 and K5: items of at most K4_ITEM_ROWS rows of one
    tile, the global list's first, then the tile's segment."""

    ends: torch.Tensor  # (ny*nx + 1,) i32: cumulative items per tile, then 0
    gmeta: torch.Tensor  # (2,) i32: the global list's rows (g_count), its items per tile


def row_boxes(bins: Bins):
    """Each row's pixel box, (x0, x1, y0, y1) inclusive, (R,) i64 each: its
    triangle's box widened by one pixel, and for a segment row clipped to
    the row's tile (empty where x1 < x0 or y1 < y0)."""
    x0, x1, y0, y1 = bins.row_box
    seg = bins.row_tile >= 0
    tx, ty = bins.row_tile % bins.nx, bins.row_tile // bins.nx
    x0 = torch.where(seg, torch.maximum(x0, tx * TILE_W), x0)
    x1 = torch.where(seg, torch.minimum(x1, tx * TILE_W + TILE_W - 1), x1)
    y0 = torch.where(seg, torch.maximum(y0, ty * TILE_H), y0)
    y1 = torch.where(seg, torch.minimum(y1, ty * TILE_H + TILE_H - 1), y1)
    return x0, x1, y0, y1


def _check_plan(bins: Bins) -> None:
    """Raises where the plan's item numbering could overflow int32: with
    every one of the table's 2T global slots live (the live count stays on
    the device), a tile has ceil(2T / K4_ITEM_ROWS) global items."""
    g_items = -(-(bins.table.shape[0] - bins.g_base) // K4_ITEM_ROWS)
    if bins.nx * bins.ny * (g_items + 1) + bins.table.shape[0] // K4_ITEM_ROWS >= 2 ** 31:
        raise ValueError("K4's and K5's work items exceed int32 offsets")


def depth_plan_plain(bins: Bins) -> DepthPlan:
    """The plan in tensor ops, with no read back to the host: tile t has
    g_items = ceil(g_count / K4_ITEM_ROWS) global items and
    ceil(counts[t] / K4_ITEM_ROWS) segment items, and `ends[t]` is the
    number of items of tiles 0..t; `ends[-1]` is 0, the counter the kernels
    take items from."""
    _check_plan(bins)
    n_tiles = bins.nx * bins.ny
    g_count = bins.g_count
    g_items = torch.div(g_count + (K4_ITEM_ROWS - 1), K4_ITEM_ROWS, rounding_mode="floor")
    per_tile = torch.div(bins.counts + (K4_ITEM_ROWS - 1), K4_ITEM_ROWS,
                         rounding_mode="floor") + g_items
    ends = torch.zeros(n_tiles + 1, dtype=torch.int32, device=bins.counts.device)
    torch.cumsum(per_tile, 0, dtype=torch.int32, out=ends[:n_tiles])
    return DepthPlan(ends, torch.stack([g_count, g_items]))


def depth_plan(bins: Bins) -> DepthPlan:
    """The plan of K4 and K5 (`depth_plan_plain`'s function): on CUDA bins
    the plan kernel makes it on the device from `counts` and `g_count`,
    with no host sync; CPU bins take the plain version."""
    dev = bins.counts.device
    if dev.type == "cpu":
        return depth_plan_plain(bins)
    if dev.type != "cuda":
        raise ValueError(f"no plan for device {dev}")
    _check_plan(bins)
    n_tiles = bins.nx * bins.ny
    _check("counts", bins.counts, torch.int32, (n_tiles,), dev)
    _check("g_count", bins.g_count, torch.int32, (), dev)
    ends = torch.empty(n_tiles + 1, dtype=torch.int32, device=dev)
    gmeta = torch.empty(2, dtype=torch.int32, device=dev)
    err = library().raster_plan(bins.counts.data_ptr(), bins.g_count.data_ptr(), n_tiles,
                                ends.data_ptr(), gmeta.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the raster plan's launch failed: cudaError {err}")
    return DepthPlan(ends, gmeta)


def depth_plan_items(bins: Bins, plan: DepthPlan):
    """The items in K4's numbering, as the kernel decodes them: (tile, first
    row, rows) per item, (n_items,) i64 each. Reads the plan's sizes back
    to the host (for tests and measurements)."""
    g_count, g_items = plan.gmeta.tolist()
    ends = plan.ends[:-1].to(torch.int64)
    item = torch.arange(int(ends[-1]), device=ends.device)
    tile = torch.searchsorted(ends, item, right=True)  # the first t with ends[t] > item
    k = item - torch.cat([ends.new_zeros(1), ends[:-1]])[tile]
    glob = k < g_items
    s = (k - g_items) * K4_ITEM_ROWS
    first = torch.where(glob, bins.g_base + k * K4_ITEM_ROWS,
                        bins.starts.to(torch.int64)[tile] + s)
    rows = torch.where(glob, (g_count - k * K4_ITEM_ROWS).clamp_max(K4_ITEM_ROWS),
                       (bins.counts.to(torch.int64)[tile] - s).clamp_max(K4_ITEM_ROWS))
    return tile, first, rows


def depth_binned_cuda(bins: Bins, width: int, height: int) -> torch.Tensor:
    """Launch K4 (after the plan kernel); returns the (height, width)
    depth."""
    global K4_LAUNCHES
    if bins.table.shape[1] != DEPTH_STRIDE:
        raise ValueError(f"K4 reads rows of {DEPTH_STRIDE} floats")
    _check_bins(bins, width, height, "K4")
    dev = bins.table.device
    plan = depth_plan(bins)
    out = torch.ones((height, width), dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().k4_depth_binned(
        bins.table.data_ptr(), *(b.data_ptr() for b in bins.row_box), bins.starts.data_ptr(),
        bins.counts.data_ptr(), plan.ends.data_ptr(), plan.gmeta.data_ptr(), bins.nx * bins.ny,
        bins.nx, bins.g_base, width, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: cudaError {err}")
    K4_LAUNCHES += 1
    return out


def vis_binned_cuda(bins: Bins, width: int, height: int) -> VisibilityBuffer:
    """Launch K5 (after the plan kernel): its launcher clears the key
    plane, runs the key pass and decodes. Returns the visibility buffer
    before any `init` merge, its four planes views of one (4, height,
    width) tensor."""
    global K5_LAUNCHES
    if bins.table.shape[1] != VIS_STRIDE:
        raise ValueError(f"K5 reads rows of {VIS_STRIDE} floats")
    _check_bins(bins, width, height, "K5")
    dev = bins.table.device
    plan = depth_plan(bins)
    keys = torch.empty(height * width, dtype=torch.int64, device=dev)
    planes = torch.empty((4, height, width), dtype=torch.float32, device=dev)
    out = VisibilityBuffer(depth=planes[0], tri=planes[1].view(torch.int32),
                           bary_u=planes[2], bary_v=planes[3])
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = library().k5_vis_binned(
        bins.table.data_ptr(), *(b.data_ptr() for b in bins.row_box), bins.starts.data_ptr(),
        bins.counts.data_ptr(), plan.ends.data_ptr(), plan.gmeta.data_ptr(), bins.nx * bins.ny,
        bins.nx, bins.g_base, width, height, keys.data_ptr(),
        *(x.data_ptr() for x in out), stream)
    if err != 0:
        raise RuntimeError(f"K5 launch failed: cudaError {err}")
    K5_LAUNCHES += 1
    return out


# -- the plain versions -------------------------------------------------------


def _row_pixel_pairs(bins: Bins, width: int, height: int):
    """(table row, px, py) for every pixel a row can cover: its triangle's
    box, and for a segment row only inside the row's tile."""
    return pixel_pairs(*row_boxes(bins), _PAIR_BUDGET)


def _edges(q, px, py):
    """Edge functions of rows q (N, stride) at pixel centers, in the
    kernels' operation order: (A·x + B·y) + C."""
    xs, ys = px.to(torch.float32) + 0.5, py.to(torch.float32) + 0.5
    e0 = q[:, 0] * xs + q[:, 1] * ys + q[:, 2]
    e1 = q[:, 3] * xs + q[:, 4] * ys + q[:, 5]
    e2 = q[:, 6] * xs + q[:, 7] * ys + q[:, 8]
    return e0, e1, e2, (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)


def depth_binned_plain(bins: Bins, width: int, height: int) -> torch.Tensor:
    """K4's function in tensor ops: per pixel min(1, least inside z)."""
    out = torch.ones(height * width, dtype=torch.float32, device=bins.table.device)
    for row, px, py in _row_pixel_pairs(bins, width, height):
        q = bins.table[row]
        e0, e1, e2, inside = _edges(q, px, py)
        z = (e1 * q[:, 9] + e2 * q[:, 10] + e0 * q[:, 11]) * q[:, 12]
        out.scatter_reduce_(0, py * width + px, torch.where(inside, z, 3.0e38), "amin")
    return out.reshape(height, width)


def _vis_terms(q, px, py):
    e0, e1, e2, inside = _edges(q, px, py)
    ia = q[:, 12]
    l0, l1, l2 = e1 * ia, e2 * ia, e0 * ia
    z = l0 * q[:, 9] + l1 * q[:, 10] + l2 * q[:, 11]
    return l0, l1, l2, z, inside


def vis_keys_plain(bins: Bins, width: int, height: int) -> torch.Tensor:
    """K5's key plane in tensor ops: per pixel the least key
    (float_order_key(z) << 32) | (0x7FFFFFFF - pos) over the rows inside it
    with z <= 1, pos the row's place in its tile's walk (the global list,
    then the segment): the least z, the latest row on a tie. (H*W,) int64,
    INT64_MAX where no row is."""
    dev = bins.table.device
    g = bins.g_count
    key = torch.full((height * width,), INT64_MAX, dtype=torch.int64, device=dev)
    starts = bins.starts.to(torch.int64)
    for row, px, py in _row_pixel_pairs(bins, width, height):
        q = bins.table[row]
        _, _, _, z, inside = _vis_terms(q, px, py)
        tile = bins.row_tile[row]
        pos = torch.where(tile >= 0, g + row - starts[tile.clamp_min(0)], row - bins.g_base)
        k = (float_order_key(z) << 32) | (0x7FFFFFFF - pos)
        key.scatter_reduce_(0, py * width + px,
                            torch.where(inside & (z <= 1.0), k, INT64_MAX), "amin")
    return key


def vis_decode_plain(bins: Bins, key: torch.Tensor, width: int,
                     height: int) -> VisibilityBuffer:
    """The visibility buffer of a key plane (`vis_keys_plain`): each covered
    pixel's row, its depth and its perspective-correct original-triangle
    barycentrics; (1, -1, 0, 0) elsewhere."""
    dev = bins.table.device
    g = bins.g_count
    starts = bins.starts.to(torch.int64)
    pix = torch.nonzero(key != INT64_MAX).squeeze(1)
    pos = 0x7FFFFFFF - (key[pix] & 0xFFFFFFFF)
    py, px = pix // width, pix % width
    tile = (py // TILE_H) * bins.nx + px // TILE_W
    row = torch.where(pos < g, bins.g_base + pos, starts[tile] + pos - g)
    q = bins.table[row]
    l0, l1, l2, z, _ = _vis_terms(q, px, py)
    lw0, lw1, lw2 = l0 * q[:, 13], l1 * q[:, 14], l2 * q[:, 15]
    denom = lw0 + lw1 + lw2
    rden = 1.0 / torch.where(denom.abs() < 1e-12, 1.0, denom)
    u = (lw0 * q[:, 16] + lw1 * q[:, 18] + lw2 * q[:, 20]) * rden
    v = (lw0 * q[:, 17] + lw1 * q[:, 19] + lw2 * q[:, 21]) * rden

    out = clear_visibility(height, width, dev)
    for plane, values in zip(out, (z, q[:, 22].to(torch.int32), u, v)):
        plane.view(-1)[pix] = values
    return out


def vis_binned_plain(bins: Bins, width: int, height: int) -> VisibilityBuffer:
    """K5's function in tensor ops: per pixel the triangle of least z <= 1,
    the latest of the walk on a tie, with its perspective-correct
    original-triangle barycentrics."""
    return vis_decode_plain(bins, vis_keys_plain(bins, width, height), width, height)


# -- drop-ins for ops/raster.py -----------------------------------------------


def _check_interpret(interpret, dev: torch.device) -> None:
    """The JAX wrappers' `interpret` (None: by backend; True: the Pallas
    kernel interpreted) maps to the port's choice by device: the plain
    version on CPU tensors (interpret=True), the kernel on CUDA tensors
    (interpret=False). A value that asks for the other raises."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no rasterizer for device {dev}")
    if interpret is not None and bool(interpret) != (dev.type == "cpu"):
        raise ValueError(f"interpret={interpret!r} with {dev.type} tensors: the port runs "
                         "the plain version on CPU tensors and the kernel on CUDA tensors")


def rasterize_depth_binned(clip, indices, width: int, height: int,
                           interpret: bool | None = None) -> torch.Tensor:
    """Depth-only binned rasterization (raster_binned.py:504-527): min z,
    clear 1.0, both windings, near-clipped. K4 on CUDA tensors, the plain
    version on CPU tensors."""
    dev = clip.device
    _check_interpret(interpret, dev)
    if indices.shape[0] == 0:
        return torch.ones((height, width), dtype=torch.float32, device=dev)
    bins = bin_triangles(tri_rows(clip, indices, width, height), width, height)
    if dev.type == "cuda":
        return depth_binned_cuda(bins, width, height)
    return depth_binned_plain(bins, width, height)


def rasterize_binned(clip, indices, width: int, height: int,
                     interpret: bool | None = None,
                     init: VisibilityBuffer | None = None) -> VisibilityBuffer:
    """Visibility-buffer binned rasterization (raster_binned.py:414-466);
    `init` is a previous buffer to depth-test against (the LOAD op). K5 on
    CUDA tensors, the plain version on CPU tensors."""
    dev = clip.device
    _check_interpret(interpret, dev)
    if indices.shape[0] == 0:
        return init if init is not None else clear_visibility(height, width, dev)
    bins = bin_triangles(tri_rows(clip, indices, width, height, vis=True), width, height)
    if dev.type == "cuda":
        vis = vis_binned_cuda(bins, width, height)
    else:
        vis = vis_binned_plain(bins, width, height)
    return vis if init is None else merge_visibility(vis, init)
