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
  leaf row -(ref + 2), WIDE_EMPTY an empty slot. Kernel K1 walks it.

Queries (`make_closest_hit`, `make_any_hit`) run the traversal of
``ops/traversal.py`` and merge the scene's analytic spheres.
"""

from __future__ import annotations

import logging
from typing import NamedTuple

import numpy as np
import torch

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.ops import traversal
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
    # Exact depths (host ints): they size the kernel's traversal stack.
    max_depth: int
    wide_depth: int

    @property
    def device(self) -> torch.device:
        return self.node_packed.device


def _collapse_wide(node_min, node_max, miss, node_leaf, width: int = WIDE_WIDTH):
    """Collapse the binary skip-pointer tree into a wide tree.

    Each wide node starts as one binary node and repeatedly replaces its
    largest-surface-area internal element with that element's two children
    until `width` slots are filled (left child = i + 1, right child =
    miss[i + 1]). Children keep the collapse order in their slots.

    Returns (wnode_packed (W, 7 * width) f32, wide_depth, leaf_perm): leaf
    rows renumbered in collapse-encounter order, as new row -> old row.
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
        for slot, e in enumerate(elems):
            if node_leaf[e] >= 0:
                refs[slot] = np.int32(-2 - len(leaf_order))
                leaf_order.append(int(node_leaf[e]))
            else:
                pending.append(e)
                depth_of.append(depth_of[w] + 1)
                refs[slot] = np.int32(len(pending) - 1)
            boxes[slot, :3] = node_min[e]
            boxes[slot, 3:] = node_max[e]
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
    return packed, int(wide_depth), np.asarray(leaf_order, np.int64)


def _finalize(positions: np.ndarray, indices: np.ndarray, node_min, node_max,
              miss, node_leaf, leaf_arr) -> dict:
    """Gather leaf triangle vertices and assemble the tables (as numpy)."""
    # The wide collapse renumbers leaf rows into collapse-encounter order; the
    # leaf table is built in the new order and the binary tree's leaf refs
    # point at each old row's first new occurrence, so both walks read one
    # table.
    node_leaf = np.asarray(node_leaf, np.int64)
    wnode_packed, wide_depth, leaf_perm = _collapse_wide(
        node_min, node_max, miss, node_leaf)
    if len(leaf_perm) == 0:
        leaf_perm = np.arange(leaf_arr.shape[0], dtype=np.int64)
    leaf_arr = np.asarray(leaf_arr)[leaf_perm]
    new_of_old = np.zeros(max(int(leaf_perm.max(initial=-1)) + 1, 1), np.int64)
    new_of_old[leaf_perm[::-1]] = np.arange(len(leaf_perm))[::-1]
    node_leaf = np.where(node_leaf >= 0,
                         new_of_old[np.maximum(node_leaf, 0)], node_leaf)

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
                wide_depth=int(wide_depth))


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


def build_bvh(positions: np.ndarray, indices: np.ndarray, device="cpu") -> BVH:
    """Build from (V,3) float32 world positions and (T,3) int indices; the
    tables land on `device`."""
    from rust_renderer_tpu_torch.convert import bvh_from_numpy

    return bvh_from_numpy(build_bvh_numpy(positions, indices), device)


def build_scene_bvh(scene) -> BVH:
    """Build over a PackedScene's world-space pools, on the scene's device."""
    return build_bvh(scene.positions.cpu().numpy(), scene.indices.cpu().numpy(),
                     scene.device)


# -- queries -------------------------------------------------------------------


def make_closest_hit(bvh: BVH):
    """closest_hit(scene, o, d, t_min, t_max) -> Hit over the BVH's triangles
    plus the scene's analytic spheres."""

    def closest_hit(scene, origin, direction, t_min=1e-3, t_max=1e4) -> Hit:
        t, prim, u, v = traversal.traverse(bvh, origin, direction, t_min, t_max)
        best = Hit(
            t=t,
            kind=torch.where(prim >= 0, HIT_TRIANGLE, HIT_NONE).to(torch.int32),
            prim=prim.clamp_min(0),
            u=u,
            v=v,
        )
        return _intersect_spheres(scene, origin, direction, t_min, t_max, best)

    return closest_hit


def make_any_hit(bvh: BVH):
    """any_hit(scene, o, d, t_min, t_max) -> bool occlusion over the BVH's
    triangles plus the scene's analytic spheres."""

    def any_hit(scene, origin, direction, t_min=1e-3, t_max=1e4):
        t, prim, _, _ = traversal.traverse(bvh, origin, direction, t_min, t_max,
                                           any_hit=True)
        hit = prim >= 0
        if scene.sphere_center.shape[0] > 0:
            shape = t.shape
            best = Hit(
                t=torch.broadcast_to(
                    torch.as_tensor(t_max, dtype=torch.float32, device=t.device),
                    shape),
                kind=torch.zeros(shape, dtype=torch.int32, device=t.device),
                prim=torch.zeros(shape, dtype=torch.int32, device=t.device),
                u=torch.zeros(shape, dtype=torch.float32, device=t.device),
                v=torch.zeros(shape, dtype=torch.float32, device=t.device),
            )
            sph = _intersect_spheres(scene, origin, direction, t_min, t_max, best)
            hit = hit | (sph.kind == HIT_SPHERE)
        return hit

    return any_hit
