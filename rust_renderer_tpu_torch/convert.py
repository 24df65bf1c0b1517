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

from rust_renderer_tpu_torch.ops.bvh import BVH
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
    """The BVH tables K1 and the plain walk use (``node_packed``,
    ``leaf_packed``, ``wnode_packed``) and the tree depths, on `device`."""
    return BVH(
        node_packed=_tensor(np.asarray(fields["node_packed"], np.float32), device),
        leaf_packed=_tensor(np.asarray(fields["leaf_packed"], np.float32), device),
        wnode_packed=_tensor(np.asarray(fields["wnode_packed"], np.float32), device),
        max_depth=int(fields["max_depth"]),
        wide_depth=int(fields["wide_depth"]),
    )


def view_from_numpy(fields: Mapping, device) -> RenderSettings:
    """The RenderSettings fields as tensors on `device`."""
    return RenderSettings(**{
        f.name: to_tensor(fields[f.name], device)
        for f in dataclasses.fields(RenderSettings)
        if f.name in fields
    })
