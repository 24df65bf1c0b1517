"""Ray/BVH traversal: kernel K1 and its plain PyTorch version.

`traverse` answers, per ray, the nearest triangle hit in (t_min, t_max) as
(t, prim, u, v) — t = INF and prim = -1 on a miss — or, with any_hit=True,
whether anything is hit (prim >= 0). It takes the plain version for CPU
tensors and launches kernel K1 for CUDA tensors; on any other device it
raises.

- K1 (``csrc/traverse_wide.cu``) walks the width-16 tree `wnode_packed`, one
  thread per ray with a private stack. It replaces the TPU kernel
  ``rust_renderer_tpu/ops/pallas/traversal.py::_make_kernel_wide_row``.
- The plain version, `traverse_plain`, is the JAX package's own reference
  walk (``ops/bvh.py::traverse``): stackless over the binary tree
  `node_packed`. The two walk different layouts of one tree, so their
  agreement is an independent check.

`K1_LAUNCHES` counts K1 launches by query kind; nothing else changes it.
"""

from __future__ import annotations

import collections
import ctypes
import os
import shutil

import torch

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.ops.rays import INF

K1_SOURCE = os.path.join(native.PACKAGE_DIR, "csrc", "traverse_wide.cu")
# Compile-time constants of the kernel (traverse_wide.cu).
K1_STACK_CAP = 256
K1_LEAF_SLOTS = 12
K1_WIDTH = 16

K1_LAUNCHES: collections.Counter = collections.Counter()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def k1_build_command() -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
            "-Xcompiler", "-fPIC"]


def k1_library() -> ctypes.CDLL:
    """Build (at first use) and bind K1."""
    lib = native.load_library("k1_traverse_wide", [K1_SOURCE], k1_build_command())
    fn = lib.k1_traverse_wide
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                       + [ctypes.c_void_p] * 5)
    return lib


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def k1_stack_need(wide_depth: int) -> int:
    """Stack entries a walk can hold: a popped wide node defers up to
    WIDTH - 1 siblings per level, plus the WIDTH children of the last pop."""
    return (K1_WIDTH - 1) * int(wide_depth) + 2 * K1_WIDTH


def traverse_wide_cuda(wnode_packed, leaf_packed, wide_depth: int, o, d,
                       t_min, t_max, any_hit: bool):
    """Launch K1 on (R,3) rays and (R,) limits, all contiguous float32 CUDA
    tensors on one device. Returns (t, prim, u, v) of shape (R,)."""
    dev = o.device
    r = o.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {dev}")
    _check("origin", o, torch.float32, (r, 3), dev)
    _check("direction", d, torch.float32, (r, 3), dev)
    _check("t_min", t_min, torch.float32, (r,), dev)
    _check("t_max", t_max, torch.float32, (r,), dev)
    _check("wnode_packed", wnode_packed, torch.float32,
           (wnode_packed.shape[0], 7 * K1_WIDTH), dev)
    _check("leaf_packed", leaf_packed, torch.float32,
           (leaf_packed.shape[0], 10 * K1_LEAF_SLOTS), dev)
    if r >= 2 ** 31:
        raise ValueError(f"{r} rays exceed one K1 launch")
    need = k1_stack_need(wide_depth)
    if need > K1_STACK_CAP:
        raise ValueError(
            f"tree of wide depth {wide_depth} needs a {need}-entry stack; "
            f"K1 is built with {K1_STACK_CAP}")
    t = torch.empty(r, dtype=torch.float32, device=dev)
    prim = torch.empty(r, dtype=torch.int32, device=dev)
    u = torch.empty(r, dtype=torch.float32, device=dev)
    v = torch.empty(r, dtype=torch.float32, device=dev)
    if r == 0:
        return t, prim, u, v
    lib = k1_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.k1_traverse_wide(
        o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
        wnode_packed.data_ptr(), leaf_packed.data_ptr(), r, int(any_hit),
        t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K1 launch failed: cudaError {err}")
    K1_LAUNCHES["any_hit" if any_hit else "closest"] += 1
    return t, prim, u, v


def _safe_inv(a: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(a.abs() < 1e-12, torch.where(a < 0, -1e-12, 1e-12), a)


def traverse_plain(node_packed, leaf_packed, o, d, t_min, t_max, any_hit: bool):
    """Stackless walk over the binary skip-pointer tree (the JAX package's
    ``ops/bvh.py::traverse``), vectorized over the rays still walking.

    o, d: (R,3); t_min, t_max: (R,). Returns (t, prim, u, v) of shape (R,).
    A ray at an internal node whose box it hits moves to node + 1, else to
    the node's skip pointer; at a leaf it tests every slot. Within a leaf
    the earlier slot keeps a tie, as the JAX walk's sequential slot loop
    does.
    """
    dev = o.device
    r = o.shape[0]
    ls = leaf_packed.shape[1] // 10
    node_i = node_packed.view(torch.int32)
    leaf_ids = leaf_packed[:, 9 * ls:].contiguous().view(torch.int32)
    leaf_geo = leaf_packed[:, :9 * ls].reshape(-1, ls, 9)
    inv = _safe_inv(d)
    slot_index = torch.arange(ls, device=dev)

    best_t = torch.clamp_max(t_max, INF).clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, dtype=torch.float32, device=dev)
    best_v = torch.zeros(r, dtype=torch.float32, device=dev)
    degenerate = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]) < 1e-12
    live = torch.nonzero(~degenerate).squeeze(1)
    cur = torch.zeros(live.shape[0], dtype=torch.int64, device=dev)

    while live.numel():
        row = node_packed[cur]
        oo, ii = o[live], inv[live]
        t0 = (row[:, 0:3] - oo) * ii
        t1 = (row[:, 3:6] - oo) * ii
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box_hit = ((tfar >= torch.maximum(tnear, t_min[live]))
                   & (tnear <= best_t[live]))
        miss = node_i[cur, 6].to(torch.int64)
        leaf = node_i[cur, 7].to(torch.int64)
        is_leaf = leaf >= 0
        finished = torch.zeros_like(box_hit)

        at_leaf = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if at_leaf.numel():
            lanes = live[at_leaf]
            rows = leaf_geo[leaf[at_leaf]]  # (k, ls, 9)
            ids = leaf_ids[leaf[at_leaf]]  # (k, ls)
            ox, oy, oz = (o[lanes, j][:, None] for j in range(3))
            dx, dy, dz = (d[lanes, j][:, None] for j in range(3))
            v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
            e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
            e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            u = (tvx * px + tvy * py + tvz * pz) * inv_det
            qx = tvy * e1z - tvz * e1y
            qy = tvz * e1x - tvx * e1z
            qz = tvx * e1y - tvy * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            bt = best_t[lanes]
            ok = ((ids >= 0) & (det.abs() > 1e-12)
                  & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > t_min[lanes][:, None]) & (t < bt[:, None]))
            tc = torch.where(ok, t, INF)
            t_best = tc.min(dim=1).values
            first = torch.where(ok & (tc == t_best[:, None]), slot_index, ls)
            slot = first.min(dim=1).values
            improved = slot < ls
            slot = slot.clamp_max(ls - 1)[:, None]
            take = lambda a: torch.gather(a, 1, slot)[:, 0]
            hit_lanes = lanes[improved]
            best_t[hit_lanes] = take(t)[improved]
            best_prim[hit_lanes] = take(ids)[improved]
            best_u[hit_lanes] = take(u)[improved]
            best_v[hit_lanes] = take(v)[improved]
            if any_hit:
                finished[at_leaf[improved]] = True

        cur = torch.where(box_hit & ~is_leaf, cur + 1, miss)
        keep = (cur >= 0) & ~finished
        live, cur = live[keep], cur[keep]

    best_t = torch.where(best_prim >= 0, best_t, INF)
    return best_t, best_prim, best_u, best_v


def traverse(bvh, origin, direction, t_min=1e-3, t_max=1e4, any_hit: bool = False):
    """Closest-hit (or any-hit) traversal of rays (..., 3) over `bvh`.

    t_min / t_max: floats or tensors broadcastable to the ray shape.
    Returns (t, prim, u, v) shaped like the rays' leading dims. CPU tensors
    take the plain walk; CUDA tensors launch K1.
    """
    shape = origin.shape[:-1]
    dev = origin.device
    o = origin.reshape(-1, 3).to(torch.float32).contiguous()
    d = direction.reshape(-1, 3).to(torch.float32).contiguous()

    def limit(x):
        if not torch.is_tensor(x):
            return torch.full((o.shape[0],), float(x), dtype=torch.float32,
                              device=dev)
        x = x.to(device=dev, dtype=torch.float32)
        return torch.broadcast_to(x, shape).reshape(-1).contiguous()

    tmin, tmax = limit(t_min), limit(t_max)
    if dev.type == "cpu":
        out = traverse_plain(bvh.node_packed, bvh.leaf_packed, o, d, tmin, tmax,
                             any_hit)
    elif dev.type == "cuda":
        out = traverse_wide_cuda(bvh.wnode_packed, bvh.leaf_packed, bvh.wide_depth,
                                 o, d, tmin, tmax, any_hit)
    else:
        raise ValueError(f"no traversal for device {dev}")
    return tuple(x.reshape(shape) for x in out)
