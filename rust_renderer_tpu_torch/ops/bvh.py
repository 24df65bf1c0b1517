"""BVH: host-side build of the traversal tables, and the hit queries.

The port of ``rust_renderer_tpu/ops/bvh.py``. One world-space BVH over all
triangles plays the role of the reference's BLAS + TLAS (utopian/src/
raytracing.rs); a transform edit re-packs and rebuilds.

Build (host numpy, the JAX package's default path): the native binned-SAH
builder emits a binary tree in DFS pre-order with skip pointers; subtrees of
at most `leaf_size` triangles collapse into one leaf; the binary tree then
collapses into a width-16 tree whose leaf-row order the tables follow.
Tables, all float32 with int32 payloads bitcast into float columns:

- ``node_packed`` (N, 8): binary node min.xyz, max.xyz, skip pointer, leaf
  row (-1 = internal). The plain traversal walks it.
- ``leaf_packed`` (L, 10 * leaf_size): leaf_size slots of [v0, e1, e2] then
  leaf_size triangle ids (-1 = empty slot).
- ``wnode_packed`` (W, 112): per wide node, column 16k + c (k < 6) is child
  c's min.xyz, max.xyz; column 96 + c is its ref: >= 0 a wide node, <= -2
  leaf row -(ref + 2), WIDE_EMPTY an empty slot. Kernels K1, K2 and the
  wide forms of K3 walk it.
- ``wnode_meta`` (W + 1, 3) int32: the collapse's child-kind masks and last
  child indices (`_collapse_wide`); the JAX package's row-cursor kernel
  reads it, and the port's kernel choice follows its presence.
- ``wnode_q32`` (W32, 128) int32, ``wnode_meta32`` (W32 + 1, 4) int32,
  ``q32_leaf_perm`` (n,) int32, ``q32_depth``: the width-32 collapse of the
  same binary tree with 16-bit quantized boxes (`_quantize_wide32`), which
  kernel K1q walks; its leaf ids map to leaf_packed rows through the perm.

Queries (`make_closest_hit`, `make_any_hit`) run the traversal of
``ops/traversal.py``, within compaction windows (``ops/compaction.py``) where
asked, and merge the scene's analytic spheres; `make_seed_test` is the
any-hit query's pre-test against the largest leaf rows.
"""

from __future__ import annotations

import ctypes
import functools
import logging
from typing import NamedTuple

import numpy as np
import torch

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.ops import compaction, traversal
from rust_renderer_tpu_torch.utils import require_port_values
from rust_renderer_tpu_torch.ops.intersect import (
    HIT_NONE,
    HIT_SPHERE,
    HIT_TRIANGLE,
    Hit,
    _intersect_spheres,
)

log = logging.getLogger(__name__)

# Leaf slots per row: the layout kernel K1 was written for (12 slots x 10
# columns = 120 columns), on every device.
LEAF_SIZE = 12
WIDE_WIDTH = 16
WIDE_EMPTY = np.int32(-0x7FFFFFFF)  # empty child-slot sentinel


class BVH(NamedTuple):
    node_packed: torch.Tensor  # (N, 8) f32
    leaf_packed: torch.Tensor  # (L, 10 * leaf_size) f32
    wnode_packed: torch.Tensor  # (W, 7 * WIDE_WIDTH) f32
    # Exact depths (host ints): they size the kernels' traversal stacks.
    max_depth: int
    wide_depth: int
    # Optional (None for a tree built without them, as in the JAX package).
    wnode_meta: torch.Tensor | None = None  # (W + 1, 3) i32
    wnode_q32: torch.Tensor | None = None  # (W32, 128) i32
    wnode_meta32: torch.Tensor | None = None  # (W32 + 1, 4) i32
    q32_leaf_perm: torch.Tensor | None = None  # (n,) i32
    q32_depth: int = 0
    # Host (L,) int64: leaf rows by decreasing summed triangle area
    # (`leaf_area_order`), which `make_seed_test` takes its rows from. Ranked
    # once at build time: the frames make their hit queries anew each frame,
    # and ranking then would read the leaf table back from the device.
    leaf_area_order: np.ndarray | None = None
    # Host (L, 10 * leaf_size) f32: the leaf rows in `leaf_area_order`, from
    # which `seed_table` compacts the seed test's triangles for any k without
    # reading the device's leaf table back.
    seed_rows: np.ndarray | None = None

    @property
    def device(self) -> torch.device:
        return self.node_packed.device

    @property
    def num_nodes(self) -> int:
        """Nodes of the binary tree."""
        return self.node_packed.shape[0]


def _collapse_wide(node_min, node_max, miss, node_leaf, width: int = WIDE_WIDTH):
    """Collapse the binary skip-pointer tree into a wide tree.

    Each wide node starts as one binary node and repeatedly replaces its
    largest-surface-area internal element with that element's two children
    until `width` slots are filled (left child = i + 1, right child =
    miss[i + 1]). Children keep the collapse order in their slots; a wide
    node's internal children are numbered contiguously (FIFO order) and so
    are its leaf children (encounter order).

    Returns (packed (W, 7 * width) f32, wide_depth, meta, leaf_perm):
    - meta (W + 1, 3) int32 for width <= 16: per wide node [int_last,
      leaf_last, static_int_rev | static_leaf_rev << width]; (W + 1, 4)
      int32 above 16: [int_last, leaf_last, static_int_rev,
      static_leaf_rev]. The static masks hold bit (width - 1 - slot) for
      each internal (leaf) child slot, so child pointer = last -
      popcount(mask & (bit - 1)). Row W is a synthetic parent of the root
      (int_last 0, static_int_rev 1 << (width - 1)).
    - leaf_perm: leaf rows renumbered in collapse-encounter order, as new
      row -> old row.
    """
    node_min = np.asarray(node_min, np.float32)
    node_max = np.asarray(node_max, np.float32)
    miss = np.asarray(miss, np.int64)
    node_leaf = np.asarray(node_leaf, np.int64)
    ext = (node_max - node_min).astype(np.float64)  # f32 squares can overflow
    area = ext[:, 0] * ext[:, 1] + ext[:, 1] * ext[:, 2] + ext[:, 2] * ext[:, 0]

    pending = [0]  # binary root of each wide node, FIFO
    depth_of = [1]
    refs_rows: list[np.ndarray] = []
    box_rows: list[np.ndarray] = []  # (width, 6)
    meta_rows: list[tuple[int, int, int, int]] = []
    leaf_order: list[int] = []
    wide_depth = 1
    w = 0
    while w < len(pending):
        b = pending[w]
        wide_depth = max(wide_depth, depth_of[w])
        elems = [b]
        while len(elems) < width:
            best = -1
            best_area = -1.0
            for k, e in enumerate(elems):
                if node_leaf[e] < 0 and area[e] > best_area:
                    best, best_area = k, float(area[e])
            if best < 0:
                break
            e = elems.pop(best)
            left = e + 1
            elems.append(left)
            elems.append(int(miss[left]))
        refs = np.full(width, WIDE_EMPTY, np.int32)
        boxes = np.zeros((width, 6), np.float32)
        boxes[:, :3] = 1.0  # empty slots: masked by the ref sentinel
        boxes[:, 3:] = -1.0
        int_base = len(pending)
        leaf_base = len(leaf_order)
        int_rev = 0
        leaf_rev = 0
        for slot, e in enumerate(elems):
            if node_leaf[e] >= 0:
                refs[slot] = np.int32(-2 - len(leaf_order))
                leaf_order.append(int(node_leaf[e]))
                leaf_rev |= 1 << (width - 1 - slot)
            else:
                pending.append(e)
                depth_of.append(depth_of[w] + 1)
                refs[slot] = np.int32(len(pending) - 1)
                int_rev |= 1 << (width - 1 - slot)
            boxes[slot, :3] = node_min[e]
            boxes[slot, 3:] = node_max[e]
        n_int = len(pending) - int_base
        n_leaf = len(leaf_order) - leaf_base
        meta_rows.append((int_base + max(n_int - 1, 0),
                          leaf_base + max(n_leaf - 1, 0), int_rev, leaf_rev))
        refs_rows.append(refs)
        box_rows.append(boxes)
        w += 1

    boxes = np.stack(box_rows)  # (W, width, 6)
    refs = np.stack(refs_rows)  # (W, width)
    packed = np.concatenate(
        [boxes.transpose(0, 2, 1).reshape(len(refs_rows), 6 * width),
         refs.view(np.float32)],
        axis=1,
    ).astype(np.float32)
    meta_rows.append((0, 0, 1 << (width - 1), 0))
    meta64 = np.asarray(meta_rows, np.int64)
    as_i32 = lambda a: (a & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    if width <= 16:
        meta = np.stack([meta64[:, 0], meta64[:, 1],
                         as_i32(meta64[:, 2] | (meta64[:, 3] << width))],
                        axis=1).astype(np.int32)
    else:
        meta = np.stack([meta64[:, 0], meta64[:, 1], as_i32(meta64[:, 2]),
                         as_i32(meta64[:, 3])], axis=1).astype(np.int32)
    return packed, int(wide_depth), meta, np.asarray(leaf_order, np.int64)


def _quantize_wide32(packed32: np.ndarray) -> np.ndarray:
    """One (128,) int32 row per width-32 wide node with 16-bit conservative
    child boxes, the layout kernel K1q reads:

    - lanes [32p + c], p = 0..2: child c's plane pairs qlo.x | qlo.y << 16,
      qlo.z | qhi.x << 16, qhi.y | qhi.z << 16;
    - lanes 96..98: the node's grid origin.xyz, 99..101 its scale.xyz (f32
      bits; plane = origin + q * scale); lanes 102..127 zero.

    The grid is widened 2 ulp beyond the children's hull, the scale rounds
    up, and every child box gets one quantization step of padding per side,
    so in exact arithmetic each dequantized box contains its f32 box. Empty
    slots are dropped by the static masks of `meta32`.
    """
    n, cols = packed32.shape
    width = 32
    assert cols == 7 * width
    boxes = packed32[:, : 6 * width].reshape(n, 6, width)
    refs = packed32[:, 6 * width:].view(np.int32)
    valid = refs != WIDE_EMPTY  # (n, 32)

    lo = boxes[:, 0:3, :]  # (n, 3, 32)
    hi = boxes[:, 3:6, :]
    big = np.float32(3e38)
    origin = np.where(valid[:, None, :], lo, big).min(axis=2)  # (n, 3)
    top = np.where(valid[:, None, :], hi, -big).max(axis=2)
    none_valid = ~valid.any(axis=1)
    origin[none_valid] = 0.0
    top[none_valid] = 0.0
    origin = np.nextafter(np.nextafter(origin, -np.inf, dtype=np.float32),
                          -np.inf, dtype=np.float32)
    top = np.nextafter(np.nextafter(top, np.inf, dtype=np.float32),
                       np.inf, dtype=np.float32)
    # The scale rounds up (f64 with a 1e-6 relative bump before the f32
    # cast), so origin + 65535 * scale reaches the hull's top.
    ext64 = top.astype(np.float64) - origin.astype(np.float64)
    scale = ((ext64 / 65535.0) * (1.0 + 1e-6)).astype(np.float32)
    safe = np.where(scale > 0, scale, 1.0).astype(np.float32)

    qlo = np.floor((lo - origin[:, :, None]) / safe[:, :, None]) - 1.0
    qhi = np.ceil((hi - origin[:, :, None]) / safe[:, :, None]) + 1.0
    qlo = np.clip(qlo, 0, 65535).astype(np.uint32)
    qhi = np.clip(qhi, 0, 65535).astype(np.uint32)
    qlo = np.where(valid[:, None, :], qlo, 0).astype(np.uint32)
    qhi = np.where(valid[:, None, :], qhi, 0).astype(np.uint32)

    row = np.zeros((n, 128), np.uint32)
    row[:, 0:32] = qlo[:, 0, :] | (qlo[:, 1, :] << 16)
    row[:, 32:64] = qlo[:, 2, :] | (qhi[:, 0, :] << 16)
    row[:, 64:96] = qhi[:, 1, :] | (qhi[:, 2, :] << 16)
    row[:, 96:99] = origin.astype(np.float32).view(np.uint32)
    row[:, 99:102] = scale.astype(np.float32).view(np.uint32)
    return row.view(np.int32)


def leaf_area_order(leaf_packed: np.ndarray) -> np.ndarray:
    """Leaf rows by decreasing summed triangle area: the ranking of the JAX
    package's `make_seed_test` (``ops/bvh.py:873-874``), in its numpy
    operations and order, over an (L, 10 * leaf_size) leaf table."""
    leaf_packed = np.asarray(leaf_packed, np.float32)
    ls = leaf_packed.shape[1] // 10
    geo = leaf_packed[:, :9 * ls].reshape(-1, ls, 9)
    e1 = np.ascontiguousarray(geo[..., 3:6])
    e2 = np.ascontiguousarray(geo[..., 6:9])
    area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=-1).sum(axis=1)
    return np.argsort(-area)


def _finalize(positions: np.ndarray, indices: np.ndarray, node_min, node_max,
              miss, node_leaf, leaf_arr) -> dict:
    """Gather leaf triangle vertices and assemble the tables (as numpy)."""
    # The wide collapse renumbers leaf rows into collapse-encounter order; the
    # leaf table is built in the new order and the binary tree's leaf refs
    # point at each old row's first new occurrence, so both walks read one
    # table.
    node_leaf = np.asarray(node_leaf, np.int64)
    wnode_packed, wide_depth, wnode_meta, leaf_perm = _collapse_wide(
        node_min, node_max, miss, node_leaf)
    if len(leaf_perm) == 0:
        leaf_perm = np.arange(leaf_arr.shape[0], dtype=np.int64)
    leaf_arr = np.asarray(leaf_arr)[leaf_perm]
    new_of_old = np.zeros(max(int(leaf_perm.max(initial=-1)) + 1, 1), np.int64)
    new_of_old[leaf_perm[::-1]] = np.arange(len(leaf_perm))[::-1]
    node_leaf = np.where(node_leaf >= 0,
                         new_of_old[np.maximum(node_leaf, 0)], node_leaf)
    # The width-32 collapse of the same binary tree, over the final leaf
    # rows: its leaf_perm maps K1q's leaf ids to rows of leaf_packed.
    w32_packed, q32_depth, meta32, q32_perm = _collapse_wide(
        node_min, node_max, miss, node_leaf, width=32)
    wnode_q32 = _quantize_wide32(w32_packed)
    if len(q32_perm) == 0:
        q32_perm = np.zeros(1, np.int64)
    safe = np.maximum(leaf_arr, 0)
    l_i = indices[safe]
    l_v0 = positions[l_i[..., 0]]
    l_v1 = positions[l_i[..., 1]]
    l_v2 = positions[l_i[..., 2]]
    pad = (leaf_arr < 0)[..., None]
    l_v0 = np.where(pad, 0.0, l_v0).astype(np.float32)
    l_e1 = np.where(pad, 0.0, l_v1 - l_v0).astype(np.float32)
    l_e2 = np.where(pad, 0.0, l_v2 - l_v0).astype(np.float32)

    miss_i = np.asarray(miss, np.int32)
    leaf_i = np.asarray(node_leaf, np.int32)
    node_packed = np.concatenate(
        [
            np.asarray(node_min, np.float32), np.asarray(node_max, np.float32),
            miss_i.view(np.float32)[:, None],
            leaf_i.view(np.float32)[:, None],
        ],
        axis=1,
    )
    n_leaves = leaf_arr.shape[0]
    # Slot s occupies columns [9s, 9s+9) as v0.xyz, e1.xyz, e2.xyz; triangle
    # ids (bitcast) fill the last leaf_size columns.
    per_slot = np.concatenate([l_v0, l_e1, l_e2], axis=2)  # (L, LS, 9)
    leaf_packed = np.concatenate(
        [per_slot.reshape(n_leaves, -1),
         leaf_arr.astype(np.int32).view(np.float32)],
        axis=1,
    )
    # Exact binary depth by a preorder walk (left = i + 1, right =
    # miss[i + 1]).
    n_nodes = len(leaf_i)
    max_depth = 1
    stack = [(0, 1)]
    while stack:
        i, depth = stack.pop()
        max_depth = max(max_depth, depth)
        if leaf_i[i] < 0 and i + 1 < n_nodes:
            stack.append((i + 1, depth + 1))
            right = miss_i[i + 1]
            if right >= 0:
                stack.append((int(right), depth + 1))
    return dict(node_packed=node_packed, leaf_packed=leaf_packed,
                wnode_packed=wnode_packed, max_depth=int(max_depth),
                wide_depth=int(wide_depth), wnode_meta=wnode_meta,
                wnode_q32=wnode_q32, wnode_meta32=meta32,
                q32_leaf_perm=q32_perm.astype(np.int32),
                q32_depth=int(q32_depth))


def _collapse_small_subtrees(node_min, node_max, miss, node_leaf, leaf_arr,
                             leaf_size):
    """Collapse every subtree holding <= leaf_size triangles into ONE full
    leaf. In the preorder skip-pointer layout subtree(i) is the node range
    [i, miss[i] or N), so subtree triangle counts are prefix-sum differences
    and the collapse tops come from one linear scan."""
    n = len(node_leaf)
    node_leaf = np.asarray(node_leaf, np.int64)
    miss = np.asarray(miss, np.int64)
    extent = np.where(miss < 0, n, miss)
    is_leaf = node_leaf >= 0
    leafcnt = np.zeros(n, np.int64)
    rows_valid = (leaf_arr >= 0).sum(1)
    leafcnt[is_leaf] = rows_valid[node_leaf[is_leaf]]
    pref = np.concatenate([[0], np.cumsum(leafcnt)])
    count = pref[extent] - pref[np.arange(n)]

    # Topmost internal nodes with a small-enough subtree.
    tops = []
    skip_until = 0
    for i in range(n):
        if i < skip_until:
            continue
        if not is_leaf[i] and count[i] <= leaf_size:
            tops.append(i)
            skip_until = extent[i]
    if not tops:
        return node_min, node_max, miss, node_leaf, leaf_arr

    inside = np.zeros(n, bool)
    top_mask = np.zeros(n, bool)
    for t in tops:
        inside[t + 1:extent[t]] = True
        top_mask[t] = True
    keep = ~inside
    new_index = np.cumsum(keep) - 1
    ext_map = np.concatenate([new_index, [new_index[-1] + 1]])  # extent -> new

    kept = np.nonzero(keep)[0]
    new_rows = []
    new_leaf = np.full(len(kept), -1, np.int64)
    for j, i in enumerate(kept):
        if top_mask[i]:
            span = slice(i, extent[i])
            lrows = node_leaf[span]
            tris = leaf_arr[lrows[lrows >= 0]].reshape(-1)
            tris = tris[tris >= 0]
            row = np.full(leaf_size, -1, np.int64)
            row[: len(tris)] = tris
            new_leaf[j] = len(new_rows)
            new_rows.append(row)
        elif is_leaf[i]:
            new_leaf[j] = len(new_rows)
            new_rows.append(leaf_arr[node_leaf[i]])
    new_miss = np.where(
        extent[kept] >= n, -1, ext_map[extent[kept]]
    ).astype(np.int64)
    return (
        np.asarray(node_min)[kept], np.asarray(node_max)[kept],
        new_miss, new_leaf, np.stack(new_rows),
    )


def build_bvh_numpy(positions: np.ndarray, indices: np.ndarray) -> dict:
    """The tables of `build_bvh` as host numpy arrays (+ depths)."""
    leaf_size = LEAF_SIZE
    positions = np.asarray(positions, np.float32)
    indices = np.asarray(indices, np.int64).reshape(-1, 3)

    # Triangles entirely beyond |1e30| (the default scene's gizmo sphere at
    # FLT_MAX) can never be hit with t_max <= 1e4; leaving them out keeps
    # infinite boxes out of the tree. Leaf rows keep the caller's triangle ids.
    indices_all = indices
    tri_map = None
    if len(indices):
        tv = positions[indices.reshape(-1)].reshape(-1, 3, 3)
        far = ~np.all(np.abs(tv) < 1e30, axis=(1, 2))
        far |= ~np.isfinite(tv).all(axis=(1, 2))
        if far.any():
            log.info("bvh: excluding %d unreachable triangles (beyond 1e30)",
                     int(far.sum()))
            keep = np.nonzero(~far)[0]
            indices = indices[keep]
            tri_map = keep.astype(np.int64)

    if len(indices) == 0:
        # Empty tree: one leaf with no triangles.
        return _finalize(
            np.zeros((1, 3), np.float32),
            np.zeros((1, 3), np.int64),
            np.zeros((1, 3), np.float32),
            np.zeros((1, 3), np.float32),
            np.full(1, -1, np.int32),
            np.zeros(1, np.int32),
            np.full((1, leaf_size), -1, np.int64),
        )

    node_min, node_max, node_miss, node_leaf, leaf_tris = native.build_bvh_sah(
        positions, indices.astype(np.int32), leaf_size)
    node_min, node_max, node_miss, node_leaf, leaf_tris = _collapse_small_subtrees(
        node_min, node_max, node_miss, node_leaf,
        leaf_tris.astype(np.int64), leaf_size,
    )
    leaf_tris = leaf_tris.astype(np.int64)
    if tri_map is not None:
        leaf_tris = np.where(leaf_tris >= 0,
                             tri_map[np.maximum(leaf_tris, 0)], -1)
    return _finalize(positions, indices_all, node_min, node_max, node_miss,
                     node_leaf, leaf_tris)


def build_bvh(positions: np.ndarray, indices: np.ndarray, leaf_size: int = LEAF_SIZE,
              use_native: bool = True, presplit_ratio: float = 1.0, reinsert_passes: int = 0,
              reinsert_child_order: str = "keep", *, device="cuda") -> BVH:
    """Build from (V,3) float32 world positions and (T,3) int indices with
    the binned-SAH builder; the tables land on `device`. The JAX options
    take only the port's values: its tables and kernels hold 12-slot leaves,
    the numpy fallback builder, reference presplitting and reinsertion
    (`ops/bvh_opt.py`) are not ported."""
    from rust_renderer_tpu_torch.convert import bvh_from_numpy

    require_port_values(
        "build_bvh", "the port builds 12-slot leaves with the native SAH builder only",
        leaf_size=(leaf_size, LEAF_SIZE), use_native=(use_native, True),
        presplit_ratio=(presplit_ratio, 1.0), reinsert_passes=(reinsert_passes, 0),
        reinsert_child_order=(reinsert_child_order, "keep"))
    return bvh_from_numpy(build_bvh_numpy(positions, indices), device)


def build_scene_bvh(scene, leaf_size: int | None = None) -> BVH:
    """Build over a PackedScene's world-space pools, on the scene's device.
    leaf_size: None (the JAX package picks by backend) or 12, the port's."""
    return build_bvh(scene.positions.cpu().numpy(), scene.indices.cpu().numpy(),
                     LEAF_SIZE if leaf_size is None else leaf_size, device=scene.device)


# -- occluder seeds --------------------------------------------------------------

# Launches of the seed kernel (csrc/seed_occlusion.cu); nothing else changes it.
SEED_LAUNCHES = 0
# The triangles one launch of the seed kernel holds in its parameters (its
# SEED_MAX_TRIS); the wrapper's launcher runs a larger table in chunks.
SEED_LAUNCH_TRIS = 8 * LEAF_SIZE
# The seed kernel's library (no TPU kernel: XLA fused the JAX package's
# make_seed_test). seed_occlusion's arguments: the rays (4), the host triangle
# table, then ints, the verdicts, the walk's directions and the stream.
SEED = native.declare("seed_occlusion", ["seed_occlusion.cu"], {
    "seed_occlusion": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 3,
}, deps=("traverse_common.cuh",))


def seed_table(bvh: BVH, k: int) -> torch.Tensor | None:
    """The live triangles of the seed test's rows, the `k` leaf rows with
    the largest summed triangle area (`BVH.leaf_area_order`), in row and
    slot order, as a host (9, n) float32 table: row c holds component
    c (v0.xyz, e1.xyz, e2.xyz) of each triangle; the JAX package's list of
    trace-time triangles. None where there are none. Read from the rows the
    build kept on the host (`BVH.seed_rows`), so no frame reads the leaf
    table back."""
    rows = bvh.seed_rows[:max(int(k), 0)]
    ls = rows.shape[1] // 10
    ids = rows[:, 9 * ls:].view(np.int32)
    r, s = np.nonzero(ids >= 0)
    if r.size == 0:
        return None
    geo = rows[:, :9 * ls].reshape(-1, ls, 9)
    return torch.from_numpy(np.ascontiguousarray(geo[r, s].T))


def seed_occlusion_plain(tris, o, d, t_min, t_max):
    """The seed test's plain version. Per ray of (R, 3) o, d and (R,)
    t_min, t_max: whether a triangle of the (9, n) table `tris`
    (`seed_table`) occludes it in (t_min, t_max), as (R,) bool, and the
    direction the walk then takes, (R, 3): zero where occluded, else d. One
    Moller-Trumbore test per triangle, in the JAX package's operations and
    order (``ops/bvh.py:884-909``; the direction as ``:1505``)."""
    tris = tris.to(o.device)
    ox, oy, oz = o[:, 0], o[:, 1], o[:, 2]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    occ = torch.zeros(o.shape[0], dtype=torch.bool, device=o.device)
    for j in range(tris.shape[1]):
        a, b, c = tris[0:3, j], tris[3:6, j], tris[6:9, j]
        px = dy * c[2] - dz * c[1]
        py = dz * c[0] - dx * c[2]
        pz = dx * c[1] - dy * c[0]
        det = b[0] * px + b[1] * py + b[2] * pz
        inv = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
        tvx, tvy, tvz = ox - a[0], oy - a[1], oz - a[2]
        u = (tvx * px + tvy * py + tvz * pz) * inv
        qx = tvy * b[2] - tvz * b[1]
        qy = tvz * b[0] - tvx * b[2]
        qz = tvx * b[1] - tvy * b[0]
        v = (dx * qx + dy * qy + dz * qz) * inv
        t = (c[0] * qx + c[1] * qy + c[2] * qz) * inv
        occ |= ((det.abs() > 1e-12) & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                & (t > t_min) & (t < t_max))
    return occ, torch.where(occ[:, None], 0.0, d)


def seed_occlusion_cuda(tris, o, d, t_min, t_max):
    """Launch the seed kernel (``csrc/seed_occlusion.cu``) on CUDA rays: the
    function of `seed_occlusion_plain`. `tris` stays on the host: its values
    travel in the launches' parameters, SEED_LAUNCH_TRIS at a time."""
    global SEED_LAUNCHES
    r, dev = traversal.check_rays("the seed kernel", o, d, t_min, t_max)
    n = tris.shape[1]
    native.check("seed table", tris, torch.float32, (9, n), torch.device("cpu"))
    if n < 1:
        raise ValueError("the seed kernel takes at least one triangle")
    occ = torch.empty(r, dtype=torch.bool, device=dev)
    walk_d = torch.empty((r, 3), dtype=torch.float32, device=dev)
    if r:
        SEED.launch(
            "seed_occlusion", "the seed kernel", dev,
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            tris.data_ptr(), n, r, occ.data_ptr(), walk_d.data_ptr())
        SEED_LAUNCHES += 1
    return occ, walk_d


def make_seed_test(bvh: BVH, k: int = 4):
    """The pre-traversal occlusion test against the `k` largest-area leaf
    rows (the JAX package's ``ops/bvh.py::make_seed_test``, which takes the
    rows' live slots, at most k x 12 triangles).

    Returns fn(origin, direction, t_min, t_max) -> (occluded, walk
    direction): occluded shaped like the rays' leading dims, the walk's
    direction like `direction`, zeroed where occluded (the rewrite
    `make_any_hit` makes, fused); or None for k <= 0 or no live triangle,
    as in the JAX package. Exact for occlusion: a seeded verdict is a true
    occlusion. CPU tensors take `seed_occlusion_plain`, CUDA tensors the
    seed kernel."""
    tris = seed_table(bvh, k)
    if tris is None:
        return None

    def test(origin, direction, t_min, t_max):
        shape = origin.shape[:-1]
        dev = origin.device
        o = origin.reshape(-1, 3).to(torch.float32).contiguous()
        d = direction.reshape(-1, 3).to(torch.float32).contiguous()
        tmin = traversal.flat_limit(t_min, shape, dev)
        tmax = traversal.flat_limit(t_max, shape, dev)
        if dev.type == "cpu":
            occ, walk_d = seed_occlusion_plain(tris, o, d, tmin, tmax)
        elif dev.type == "cuda":
            occ, walk_d = seed_occlusion_cuda(tris, o, d, tmin, tmax)
        else:
            raise ValueError(f"no seed test for device {dev}")
        return occ.reshape(shape), walk_d.reshape(origin.shape)

    return test


# -- queries -------------------------------------------------------------------


def _traversal(compact_window: int, compact_order: str):
    """traverse, or traverse within compaction windows of `compact_window`
    ray blocks (the JAX package's `_pick_traversal`)."""
    if compact_window > 1:
        return functools.partial(compaction.traverse_compacted,
                                 window_blocks=compact_window, trav=traversal.traverse,
                                 order=compact_order)
    return traversal.traverse


_MOSAIC = "it schedules Pallas work on the TPU; the port's walks give the same hits"


def make_closest_hit(bvh: BVH, packet: bool = True, sort: bool = False,
                     wide: bool = True, ordered: bool = False,
                     compact_window: int = 0, steady_drain: int = 3,
                     compact_order: str = "morton", row_cursors: int = 8,
                     row_expand: int = 2, q32: bool = False, skip_drain: bool = True):
    """closest_hit(scene, o, d, t_min, t_max) -> Hit over the BVH's triangles
    plus the scene's analytic spheres.

    The options of the JAX signature, with its defaults: `wide`, `ordered`,
    `steady_drain`, `row_cursors` and `q32` choose the kernel
    (`traversal.select_kernel`), `dual` derived as the JAX package derives
    it; the defaults launch K1. `compact_window` > 1 walks the rays within
    compaction windows of that many ray blocks, live lanes first and, with
    `compact_order="morton"`, by their origins' Morton code
    (``ops/compaction.py``); the hits are the same. The options that only
    schedule Pallas work (`packet`, `sort`, `row_expand`, `skip_drain`) take
    only their JAX defaults (`utils.require_port_values`)."""
    require_port_values("make_closest_hit", _MOSAIC, packet=(packet, True), sort=(sort, False),
                        row_expand=(row_expand, 2), skip_drain=(skip_drain, True))
    options = dict(wide=wide, ordered=ordered, dual=steady_drain > 0,
                   steady_drain=steady_drain, row_cursors=row_cursors, q32=q32)
    trav = _traversal(compact_window, compact_order)

    def closest_hit(scene, origin, direction, t_min=1e-3, t_max=1e4) -> Hit:
        t, prim, u, v = trav(bvh, origin, direction, t_min, t_max, **options)
        best = Hit(
            t=t,
            kind=torch.where(prim >= 0, HIT_TRIANGLE, HIT_NONE).to(torch.int32),
            prim=prim.clamp_min(0),
            u=u,
            v=v,
        )
        return _intersect_spheres(scene, origin, direction, t_min, t_max, best)

    return closest_hit


def make_any_hit(bvh: BVH, packet: bool = True, sort: bool = False,
                 wide: bool = True, ordered: bool = False,
                 compact_window: int = 0, steady_drain: int = 3,
                 compact_order: str = "morton", seed_rows: int = 0,
                 row_cursors: int = 8, row_expand: int = 2, q32: bool = False,
                 skip_drain: bool = True, skip_expand: bool = True):
    """any_hit(scene, o, d, t_min, t_max) -> bool occlusion over the BVH's
    triangles plus the scene's analytic spheres. Options as
    `make_closest_hit`; any-hit walks are `dual` and, with a steady drain,
    `drain_first`, as in the JAX package. `seed_rows` > 0 first tests every
    ray against that many largest-area leaf rows (`make_seed_test`): a
    seeded ray gets a zero direction, so the walk retires it on entry (and
    compaction moves it out of the live lanes), and its verdict is ORed in
    (``ops/bvh.py:1501-1511``)."""
    require_port_values("make_any_hit", _MOSAIC, packet=(packet, True), sort=(sort, False),
                        row_expand=(row_expand, 2), skip_drain=(skip_drain, True),
                        skip_expand=(skip_expand, True))
    options = dict(wide=wide, ordered=ordered, dual=True,
                   steady_drain=steady_drain, drain_first=steady_drain > 0,
                   row_cursors=row_cursors, q32=q32)
    trav = _traversal(compact_window, compact_order)
    seed = make_seed_test(bvh, seed_rows)

    def any_hit(scene, origin, direction, t_min=1e-3, t_max=1e4):
        occ_seed = None
        if seed is not None:
            occ_seed, direction = seed(origin, direction, t_min, t_max)
        t, prim, _, _ = trav(bvh, origin, direction, t_min, t_max, any_hit=True,
                             **options)
        hit = prim >= 0
        if occ_seed is not None:
            hit = hit | occ_seed
        if scene.sphere_center.shape[0] > 0:
            shape = t.shape
            best = Hit(
                t=traversal.flat_limit(t_max, shape, t.device).reshape(shape),
                kind=torch.zeros(shape, dtype=torch.int32, device=t.device),
                prim=torch.zeros(shape, dtype=torch.int32, device=t.device),
                u=torch.zeros(shape, dtype=torch.float32, device=t.device),
                v=torch.zeros(shape, dtype=torch.float32, device=t.device),
            )
            sph = _intersect_spheres(scene, origin, direction, t_min, t_max, best)
            hit = hit | (sph.kind == HIT_SPHERE)
        return hit

    return any_hit
