"""Data carried across from numpy into the port's structures.

The JAX package's scene, BVH and view structures, given as dicts of numpy
arrays (``np.asarray`` of each field), become the port's tensors on one
device, so both packages can compute over identical inputs. The port's own
host code builds its tensors through the same functions.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import numpy as np
import torch

from rust_renderer_tpu_torch.ops.bvh import BVH, LEAF_SIZE, leaf_area_order
from rust_renderer_tpu_torch.ops.raster import VisibilityBuffer
from rust_renderer_tpu_torch.ops.restir import Reservoir
from rust_renderer_tpu_torch.renderer import PackedScene
from rust_renderer_tpu_torch.settings import RenderSettings, to_tensor

_SCENE_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint8): torch.uint8,
}


def _tensor(value, device) -> torch.Tensor:
    arr = np.ascontiguousarray(value)
    if arr.dtype not in _SCENE_DTYPES:
        raise ValueError(f"unexpected dtype {arr.dtype}")
    return torch.tensor(arr, dtype=_SCENE_DTYPES[arr.dtype], device=device)


def packed_scene_from_numpy(fields: Mapping, device) -> PackedScene:
    """The fields of ``renderer.py::PackedScene`` as tensors on `device`."""
    return PackedScene(**{
        f.name: _tensor(fields[f.name], device)
        for f in dataclasses.fields(PackedScene)
    })


def bvh_from_numpy(fields: Mapping, device) -> BVH:
    """The BVH tables (``node_packed``, ``leaf_packed``, ``wnode_packed``)
    and the tree depths, on `device`; with the optional row-cursor and q32
    tables (``wnode_meta``, ``wnode_q32``, ``wnode_meta32``,
    ``q32_leaf_perm``, ``q32_depth``) where `fields` holds them and they are
    not None; and, on the host, the leaf rows' area ranking that the seed
    test reads (``ops/bvh.py::leaf_area_order``) and the leaf rows in that
    order (``BVH.seed_rows``)."""

    def optional(name):
        value = fields.get(name)
        return None if value is None else _tensor(np.asarray(value, np.int32), device)

    leaf_packed = np.asarray(fields["leaf_packed"], np.float32)
    order = leaf_area_order(leaf_packed)
    return BVH(
        node_packed=_tensor(np.asarray(fields["node_packed"], np.float32), device),
        leaf_packed=_tensor(leaf_packed, device),
        wnode_packed=_tensor(np.asarray(fields["wnode_packed"], np.float32), device),
        max_depth=int(fields["max_depth"]),
        wide_depth=int(fields["wide_depth"]),
        wnode_meta=optional("wnode_meta"),
        wnode_q32=optional("wnode_q32"),
        wnode_meta32=optional("wnode_meta32"),
        q32_leaf_perm=optional("q32_leaf_perm"),
        q32_depth=int(fields.get("q32_depth") or 0),
        leaf_area_order=order,
        seed_rows=leaf_packed[order],
    )


def view_from_numpy(fields: Mapping, device) -> RenderSettings:
    """The RenderSettings fields as tensors on `device`."""
    return RenderSettings(**{
        f.name: to_tensor(fields[f.name], device)
        for f in dataclasses.fields(RenderSettings)
        if f.name in fields
    })


def shadow_cascades_from_numpy(matrices, splits, device):
    """Cascade view-projections (C, 4, 4) and split depths (C,) as float32
    tensors on `device`."""
    return (_tensor(np.asarray(matrices, np.float32), device),
            _tensor(np.asarray(splits, np.float32), device))


def environment_from_numpy(resources: Mapping, device) -> dict[str, torch.Tensor]:
    """The captured environment (env_cubemap_mip*, specular_map_mip*,
    irradiance_map, brdf_lut) as float32 tensors on `device`."""
    return {name: _tensor(np.asarray(value, np.float32), device)
            for name, value in resources.items()}


def visibility_from_numpy(vis, device) -> VisibilityBuffer:
    """A visibility buffer (depth, tri, bary_u, bary_v) on `device`, the
    `init` of a LOAD-op rasterization."""
    depth, tri, bary_u, bary_v = (np.asarray(x) for x in vis)
    return VisibilityBuffer(
        depth=_tensor(depth.astype(np.float32), device),
        tri=_tensor(tri.astype(np.int32), device),
        bary_u=_tensor(bary_u.astype(np.float32), device),
        bary_v=_tensor(bary_v.astype(np.float32), device))


def reservoir_from_numpy(planes, device) -> Reservoir:
    """A reservoir's planes (Y, W_sum, W_X, M), the frame-carried ReSTIR
    state, on `device`: Y and M int32, the weights float32."""
    y, w_sum, w_x, m = (np.asarray(p) for p in planes)
    return Reservoir(Y=_tensor(y.astype(np.int32), device),
                     W_sum=_tensor(w_sum.astype(np.float32), device),
                     W_X=_tensor(w_x.astype(np.float32), device),
                     M=_tensor(m.astype(np.int32), device))


def dynamic_tables_from_numpy(tables: Mapping, device) -> dict[str, torch.Tensor]:
    """The marching-cubes refit tables of the JAX package's
    ``ops/mc_bvh.py::build_dynamic_tables`` (mc_wnode, mc_node, mc_leaf,
    mc_tri_normals) as the port's, on `device`. The leaf rows go from the
    JAX layout, 10 slots at 100 columns, to the port's 12 slots at 120
    (``ops/mc_bvh.py``): the 10 slots in order, then two dead slots with
    zero geometry and id -1."""
    leaf = np.asarray(tables["mc_leaf"], np.float32)
    rows, slots = leaf.shape[0], leaf.shape[1] // 10
    geo = np.zeros((rows, LEAF_SIZE, 9), np.float32)
    geo[:, :slots] = leaf[:, :9 * slots].reshape(rows, slots, 9)
    ids = np.full((rows, LEAF_SIZE), -1, np.int32)
    ids[:, :slots] = leaf[:, 9 * slots:].view(np.int32)
    out = {name: _tensor(np.asarray(tables[name], np.float32), device)
           for name in ("mc_wnode", "mc_node", "mc_tri_normals")}
    out["mc_leaf"] = _tensor(np.concatenate([geo.reshape(rows, -1), ids.view(np.float32)], 1),
                             device)
    return out
