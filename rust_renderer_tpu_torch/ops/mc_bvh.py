"""A BVH over the marching-cubes voxel grid, refit on the device every frame:
the animated isosurface in the path-traced scene (bench config 5). The port
of ``rust_renderer_tpu/ops/mc_bvh.py``.

Every triangle that cell (x, y, z) emits lies inside that cell, so the
tree's topology is static: a width-16 tree over the grid's cells in Morton
order, built once per grid size on the host (`_static_topology`). Only the
boxes are refit each frame, as tight min / max over each cell's emitted
vertices (`build_dynamic_scene`). The tables feed the same traversal as the
static scene (K1 on CUDA tensors, `traversal.traverse_plain` on CPU
tensors), and the dynamic hit merges with the static one by nearest t
(`combine_closest_hit`, `combine_any_hit`).

Leaf row j holds the two Morton-adjacent cells of ranks 2j and 2j + 1, and
the rows follow Morton rank, so every wide node's children are contiguous
(the JAX package's row-cursor metadata, `wnode_meta`, comes from the static
topology). A row is laid out at the port's 12 slots (``ops/bvh.py``'s
LEAF_SIZE, which every traversal kernel is compiled for): cell 0's five
slots, cell 1's five, then two dead slots (geometry zero, id -1); the 108
geometry columns come first, then the 12 ids. The JAX package's rows hold
the same 10 live slots in the same order at 100 columns, so nearest hits and
their tie-breaking are the same.

Triangle ids index the MC result's slot-major triangle array (slot s of cell
v is s * V + v), so shading fetches the MC normals with one row gather.

The constants the refit and the shading read (Morton order, child refs,
row-cursor metadata, the material and colour) are device tensors made once
per (grid, device) or value: the frame bodies that read them are captured
into CUDA graphs, where a host-to-device copy cannot run.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from rust_renderer_tpu_torch.ops import traversal
from rust_renderer_tpu_torch.ops.bvh import BVH, LEAF_SIZE, WIDE_EMPTY, WIDE_WIDTH
from rust_renderer_tpu_torch.ops.gather import row_gather
from rust_renderer_tpu_torch.ops.intersect import HIT_DYNAMIC, Hit
from rust_renderer_tpu_torch.ops.constants import device_constant
from rust_renderer_tpu_torch.ops.marching_cubes import MAX_TRIS_PER_VOXEL
from rust_renderer_tpu_torch.utils.profiler import PROFILER

_BIG = 3.0e37
CELLS_PER_ROW = 2  # Morton-adjacent cells sharing one leaf row
# The walk's options: the JAX package's `_dyn_traverse` settings, which
# `traversal.select_kernel` sends to K1 (the tree carries wnode_meta).
_WALK = dict(wide=True, dual=True, steady_drain=3, row_cursors=8)


def _morton3(x: np.ndarray, y: np.ndarray, z: np.ndarray, bits: int) -> np.ndarray:
    def expand(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & 0x030000FF
        v = (v | (v << 8)) & 0x0300F00F
        v = (v | (v << 4)) & 0x030C30C3
        v = (v | (v << 2)) & 0x09249249
        return v

    return expand(x) | (expand(y) << 1) | (expand(z) << 2)


@functools.lru_cache(maxsize=8)
def _static_topology(grid: int) -> dict:
    """Host side, once per grid size (the JAX package's, unchanged): the
    Morton cell order, the wide tree's child refs and row-cursor metadata,
    and the binary skip tree's columns. Leaf row j = Morton ranks [2j,
    2j + 1]; rows are rank-ordered, so every wide node's children are
    contiguous."""
    if grid < 2 or grid & (grid - 1):
        raise ValueError(f"mc grid must be a power of two >= 2, got {grid}")
    v = grid ** 3
    rows = v // CELLS_PER_ROW
    ii = np.arange(grid)
    gx, gy, gz = np.meshgrid(ii, ii, ii, indexing="ij")
    linear = (gx * grid * grid + gy * grid + gz).reshape(-1)
    codes = _morton3(gx.reshape(-1), gy.reshape(-1), gz.reshape(-1), 5)
    morton_cells = linear[np.argsort(codes, kind="stable")]  # rank -> linear

    # The wide tree: 16-ary over the rank-ordered leaf rows, levels bottom
    # up; level_sizes = [R, R/16, ..., 1]; node order = [root, ..., level 1].
    level_sizes = [rows]
    while level_sizes[-1] > 1:
        level_sizes.append(-(-level_sizes[-1] // WIDE_WIDTH))
    n_internal_levels = len(level_sizes) - 1
    offsets = {}  # internal level (1 = over leaf rows) -> first node
    off = 0
    for li in range(n_internal_levels, 0, -1):
        offsets[li] = off
        off += level_sizes[li]
    n_wide = off
    wide_refs = np.full((n_wide, WIDE_WIDTH), WIDE_EMPTY, np.int32)
    # Row-cursor metadata in ops/bvh.py::_collapse_wide's encoding: [int_last,
    # leaf_last, int_rev | leaf_rev << 16], a synthetic root row last.
    meta = np.zeros((n_wide + 1, 3), np.int32)
    for li in range(n_internal_levels, 0, -1):
        n_children = level_sizes[li - 1]
        for i in range(level_sizes[li]):
            node = offsets[li] + i
            nc = min(WIDE_WIDTH, n_children - i * WIDE_WIDTH)
            rev = 0
            for c in range(nc):
                child = i * WIDE_WIDTH + c
                rev |= 1 << (WIDE_WIDTH - 1 - c)
                if li == 1:  # children are leaf rows, contiguous by rank
                    wide_refs[node, c] = np.int32(-2 - child)
                else:
                    wide_refs[node, c] = np.int32(offsets[li - 1] + child)
            if li == 1:
                meta[node] = (0, i * WIDE_WIDTH + nc - 1,
                              np.int32(np.uint32(rev << WIDE_WIDTH)))
            else:
                meta[node] = (offsets[li - 1] + i * WIDE_WIDTH + nc - 1, 0, rev)
    meta[n_wide] = (0, 0, 1 << (WIDE_WIDTH - 1))  # synthetic root entry

    # The binary skip tree (the plain walk's): a complete heap over the
    # rank-ordered leaf rows, in preorder.
    n_bin = 2 * rows - 1
    pre2heap = np.zeros(n_bin, np.int64)
    miss_pre = np.full(n_bin, -1, np.int32)
    leaf_pre = np.full(n_bin, -1, np.int32)
    p = 0
    stack = [1]
    while stack:
        h = stack.pop()
        pre2heap[p] = h
        size = 2 * (rows >> (h.bit_length() - 1)) - 1
        miss_pre[p] = p + size if p + size < n_bin else -1
        if h >= rows:  # a leaf row (already rank-ordered)
            leaf_pre[p] = h - rows
        else:
            stack.append(2 * h + 1)
            stack.append(2 * h)
        p += 1
    bin_cols = np.stack([miss_pre.view(np.float32), leaf_pre.view(np.float32)], axis=1)
    return dict(
        morton_cells=morton_cells.astype(np.int32),
        rows=rows,
        wide_refs=wide_refs,
        wide_meta=meta,
        wide_level_sizes=tuple(level_sizes),
        wide_depth=n_internal_levels,
        pre2heap=pre2heap,
        bin_cols=bin_cols,
        miss_pre=miss_pre,
        leaf_pre=leaf_pre,
        bin_depth=int(np.log2(rows)) + 1,
    )


@functools.cache
def _device_topology(grid: int, device: torch.device) -> dict:
    """The static topology's tables on `device`, made once: the Morton
    order (rank -> linear cell), each leaf row's 12 slot ids (-1 in the dead
    slots), the wide child refs as float32 bit patterns, the row-cursor
    metadata, the preorder -> heap row map and the skip tree's columns."""
    topo = _static_topology(grid)
    v = grid ** 3
    rows = topo["rows"]
    cells = topo["morton_cells"].astype(np.int64).reshape(rows, CELLS_PER_ROW)
    live = (np.arange(MAX_TRIS_PER_VOXEL, dtype=np.int64)[None, None, :] * v
            + cells[:, :, None]).reshape(rows, CELLS_PER_ROW * MAX_TRIS_PER_VOXEL)
    dead = np.full((rows, LEAF_SIZE - live.shape[1]), -1, np.int64)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return dict(
        morton=put(topo["morton_cells"].astype(np.int64)),
        slot_ids=put(np.concatenate([live, dead], axis=1).astype(np.int32)),
        wide_refs=put(topo["wide_refs"].view(np.float32)),
        wide_meta=put(topo["wide_meta"]),
        pre=put(topo["pre2heap"] - 1),
        bin_cols=put(topo["bin_cols"]),
    )


class DynamicScene(NamedTuple):
    """One frame's dynamic geometry: the refit tree and its shading data."""

    bvh: BVH  # the walks' tables (node_packed, leaf_packed, wnode_packed, wnode_meta)
    normals_rows: torch.Tensor  # (5V, 9): per-triangle vertex normals
    material: torch.Tensor  # () int32 material id (Lambertian, the MC colour)


def table_shapes(grid: int) -> dict[str, tuple[int, ...]]:
    """Shapes of the tables `build_dynamic_tables` returns, so a graph can
    declare them as resources (the refit runs as a pass of its own). The
    leaf rows are (rows, 120): 12 slots of 10 columns, the port's layout
    (module docstring), where the JAX package's are (rows, 100)."""
    topo = _static_topology(grid)
    return {
        "mc_wnode": (topo["wide_refs"].shape[0], 7 * WIDE_WIDTH),
        "mc_node": (2 * topo["rows"] - 1, 8),
        "mc_leaf": (topo["rows"], 10 * LEAF_SIZE),
        "mc_tri_normals": (MAX_TRIS_PER_VOXEL * grid ** 3, 9),
    }


def build_dynamic_tables(mc_result, grid: int) -> dict[str, torch.Tensor]:
    """The refit: an MC result -> the tables named by `table_shapes`."""
    scene = build_dynamic_scene(mc_result, grid, 0)
    return {
        "mc_wnode": scene.bvh.wnode_packed,
        "mc_node": scene.bvh.node_packed,
        "mc_leaf": scene.bvh.leaf_packed,
        "mc_tri_normals": scene.normals_rows,
    }


def _dynamic_bvh(grid: int, node_packed, leaf_packed, wnode_packed) -> BVH:
    """The refit tables as a BVH, with the static topology's metadata and
    depths. The q32 tables and seed rows stay None, so `select_kernel`
    cannot send the tree to K1q and no seed test is made over it."""
    topo = _static_topology(grid)
    return BVH(node_packed=node_packed, leaf_packed=leaf_packed, wnode_packed=wnode_packed,
               max_depth=topo["bin_depth"], wide_depth=topo["wide_depth"],
               wnode_meta=_device_topology(grid, node_packed.device)["wide_meta"])


def dynamic_scene_from_tables(tables, grid: int, material_id: int) -> DynamicScene:
    """A DynamicScene from refit tables carried as graph resources. It reads
    only device tensors made once, so a captured frame body may call it."""
    dev = tables["mc_node"].device
    return DynamicScene(
        bvh=_dynamic_bvh(grid, tables["mc_node"], tables["mc_leaf"], tables["mc_wnode"]),
        normals_rows=tables["mc_tri_normals"],
        material=device_constant(int(material_id), dev, torch.int32),
    )


def _depoison(bmin, bmax):
    """Empty boxes (min > max on an axis) as a point at +_BIG: a ray's entry
    then lies near +3e25, beyond any best hit, so no ray enters. An inverted
    box must never reach a packed table: the slab test orders each axis's
    interval with min / max, so it tests as covering everything and every
    ray walks the whole tree."""
    empty = (bmin > bmax).any(dim=-1, keepdim=True)
    return torch.where(empty, _BIG, bmin), torch.where(empty, _BIG, bmax)


def build_dynamic_scene(mc_result, grid: int, material_id: int) -> DynamicScene:
    """Refit the static-topology tree to this frame's MC output, on the
    device of its tensors.

    mc_result: ``ops/marching_cubes.py``'s MarchingCubesResult with
    slot-major (5V, 3, 3) positions / normals and (5V,) valid."""
    topo = _static_topology(grid)
    dt = _device_topology(grid, mc_result.positions.device)
    v = grid ** 3
    rows = topo["rows"]
    ls = MAX_TRIS_PER_VOXEL
    ls_row = CELLS_PER_ROW * ls

    # Slot-major (5V, ...) -> per cell (V, 5, ...), then Morton rank order,
    # two cells per leaf row.
    pos = mc_result.positions.reshape(ls, v, 3, 3).transpose(0, 1)
    valid = mc_result.valid.reshape(ls, v).transpose(0, 1)
    pos_r = pos[dt["morton"]].reshape(rows, ls_row, 3, 3)
    val_r = valid[dt["morton"]].reshape(rows, ls_row)

    # Leaf rows: slot s's columns [9s, 9s + 9) are v0, e1, e2 (cell 0 in
    # slots 0-4, cell 1 in 5-9, slots 10 and 11 dead), then 12 ids.
    v0 = pos_r[..., 0, :]
    per_slot = torch.where(val_r[..., None],
                           torch.cat([v0, pos_r[..., 1, :] - v0, pos_r[..., 2, :] - v0], -1),
                           0.0)
    per_slot = torch.cat([per_slot, per_slot.new_zeros((rows, LEAF_SIZE - ls_row, 9))], 1)
    ids = torch.where(torch.cat([val_r, val_r.new_zeros((rows, LEAF_SIZE - ls_row))], 1),
                      dt["slot_ids"], -1)
    leaf_packed = torch.cat([per_slot.reshape(rows, 9 * LEAF_SIZE),
                             ids.to(torch.int32).view(torch.float32)], 1)

    # Leaf boxes, tight over the emitted vertices; empty cells inverted (the
    # identities of the unions below), depoisoned only where packed.
    flat = pos_r.reshape(rows, ls_row * 3, 3)
    vmask = val_r.repeat_interleave(3, dim=1)[..., None]
    bmin = torch.where(vmask, flat, _BIG).amin(dim=1)
    bmax = torch.where(vmask, flat, -_BIG).amax(dim=1)

    # Level reductions and the wide nodes' box rows (node order: root first).
    level_sizes = topo["wide_level_sizes"]
    mins, maxs, level_rows = bmin, bmax, {}
    for li in range(1, len(level_sizes)):
        n = level_sizes[li]
        pad = n * WIDE_WIDTH - mins.shape[0]
        if pad:
            mins = torch.cat([mins, mins.new_full((pad, 3), _BIG)])
            maxs = torch.cat([maxs, maxs.new_full((pad, 3), -_BIG)])
        gmin = mins.reshape(n, WIDE_WIDTH, 3)
        gmax = maxs.reshape(n, WIDE_WIDTH, 3)
        mins, maxs = gmin.amin(dim=1), gmax.amax(dim=1)
        level_rows[li] = torch.cat(_depoison(gmin, gmax), -1)  # (n, 16, 6)
    node_rows = torch.cat([level_rows[li] for li in range(len(level_sizes) - 1, 0, -1)])
    wnode_packed = torch.cat([node_rows.transpose(1, 2).reshape(-1, 6 * WIDE_WIDTH),
                              dt["wide_refs"]], 1)

    # The binary skip tree: heap levels, then preorder.
    hmins, hmaxs = [bmin], [bmax]
    while hmins[-1].shape[0] > 1:
        n = hmins[-1].shape[0] // 2
        hmins.append(hmins[-1].reshape(n, 2, 3).amin(dim=1))
        hmaxs.append(hmaxs[-1].reshape(n, 2, 3).amax(dim=1))
    heap_min = torch.cat(hmins[::-1])  # heap index h -> row h - 1
    heap_max = torch.cat(hmaxs[::-1])
    pre_min, pre_max = _depoison(heap_min[dt["pre"]], heap_max[dt["pre"]])
    node_packed = torch.cat([pre_min, pre_max, dt["bin_cols"]], 1)

    return DynamicScene(
        bvh=_dynamic_bvh(grid, node_packed, leaf_packed, wnode_packed),
        normals_rows=mc_result.normals.reshape(-1, 9),
        material=device_constant(int(material_id), node_packed.device, torch.int32),
    )


def dyn_traverse(dyn: DynamicScene, origin, direction, t_min, t_max, any_hit: bool = False):
    """The walk of the dynamic tree, with the JAX package's `_dyn_traverse`
    options: on CUDA tensors K1 (raises if `select_kernel` named another
    kernel), on CPU tensors the plain walk. Returns (t, prim, u, v). Inside
    the span `mc/walk`, which a pass's span encloses, so that a captured
    frame's replays time it too."""
    if origin.device.type == "cuda":
        kernel = traversal.select_kernel(dyn.bvh, any_hit, **_WALK)
        if kernel != "k1":
            raise RuntimeError(f"the dynamic tree's walk selected {kernel}, not K1")
    with PROFILER.scope("mc/walk", device=origin.device):
        return traversal.traverse(dyn.bvh, origin, direction, t_min, t_max, any_hit=any_hit,
                                  drain_first=any_hit, **_WALK)


def combine_closest_hit(base_closest, dyn: DynamicScene):
    """closest_hit that also walks the dynamic tree; the nearer hit wins (a
    tie goes to the scene). Dynamic hits carry kind HIT_DYNAMIC and prim =
    the slot-major MC triangle index. Each query adds its lanes that the
    surface won to the device counter `mc/hits`, its peak one query's."""

    def closest_hit(scene, origin, direction, t_min=1e-3, t_max=1e4) -> Hit:
        base = base_closest(scene, origin, direction, t_min, t_max)
        t, prim, u, v = dyn_traverse(dyn, origin, direction, t_min, t_max)
        closer = t < base.t
        won = closer.sum()
        PROFILER.count("mc/hits", won, won)
        return Hit(
            t=torch.where(closer, t, base.t),
            kind=torch.where(closer, HIT_DYNAMIC, base.kind).to(torch.int32),
            prim=torch.where(closer, prim.clamp_min(0), base.prim),
            u=torch.where(closer, u, base.u),
            v=torch.where(closer, v, base.v),
        )

    return closest_hit


def combine_any_hit(base_any, dyn: DynamicScene):
    """any_hit that also walks the dynamic tree: occluded by either."""

    def any_hit(scene, origin, direction, t_min=1e-3, t_max=1e4):
        occluded = base_any(scene, origin, direction, t_min, t_max)
        prim = dyn_traverse(dyn, origin, direction, t_min, t_max, any_hit=True)[1]
        return occluded | (prim >= 0)

    return any_hit


def _hit_normals(dyn: DynamicScene, hit: Hit) -> torch.Tensor:
    """The MC gradient normals interpolated at each hit by its barycentrics
    (one row gather), normalized."""
    rows = row_gather(dyn.normals_rows, hit.prim.reshape(-1)).reshape(hit.t.shape + (9,))
    w0 = (1.0 - hit.u - hit.v)[..., None]
    w1 = hit.u[..., None]
    w2 = hit.v[..., None]
    n = rows[..., 0:3] * w0 + rows[..., 3:6] * w1 + rows[..., 6:9] * w2
    return n / torch.clamp_min(torch.linalg.vector_norm(n, dim=-1, keepdim=True), 1e-9)


def surface_patch(dyn: DynamicScene, hit: Hit, direction, surf):
    """Overwrite Surface fields on dynamic-hit lanes: the MC normals (the
    shading normal flipped toward the ray), the MC material, mesh -2 and
    uv 0 (the MC surface is untextured)."""
    is_dyn = hit.kind == HIT_DYNAMIC
    geo = _hit_normals(dyn, hit)
    facing = (geo * direction).sum(dim=-1, keepdim=True) > 0.0
    n = torch.where(facing, -geo, geo)
    m = is_dyn[..., None]
    return surf._replace(
        normal=torch.where(m, n, surf.normal),
        geo_normal=torch.where(m, geo, surf.geo_normal),
        uv=torch.where(m, 0.0, surf.uv),
        material=torch.where(is_dyn, dyn.material, surf.material),
        mesh=torch.where(is_dyn, -2, surf.mesh).to(torch.int32),
    )


def patch_gbuffer(dyn: DynamicScene, hit: Hit, direction, gb, mc_color):
    """Fill the gbuffer planes on dynamic-hit lanes: the normal from the MC
    gradients, albedo the MC pass colour, pbr a rough dielectric with the
    MC material id."""
    del direction  # the JAX signature's; the gbuffer normal is not flipped
    is_dyn = hit.kind == HIT_DYNAMIC
    shape = hit.t.shape
    dev = hit.t.device
    n = _hit_normals(dyn, hit)
    one = torch.ones(shape + (1,), dtype=torch.float32, device=dev)
    albedo = torch.broadcast_to(
        device_constant(tuple(float(c) for c in mc_color[:3]), dev), shape + (3,))
    pbr = torch.cat([torch.zeros_like(one), one, one,
                     torch.broadcast_to(dyn.material.to(torch.float32), shape)[..., None]], -1)
    m = is_dyn[..., None]
    return gb._replace(
        normal=torch.where(m, torch.cat([n, one], -1), gb.normal),
        albedo=torch.where(m, torch.cat([albedo, one], -1), gb.albedo),
        pbr=torch.where(m, pbr, gb.pbr),
    )
