"""Windowed live-lane compaction of traversal fronts (the port of
``rust_renderer_tpu/ops/compaction.py``).

A front's lanes are cut into windows of `window_blocks` adjacent ray blocks
of BLOCK lanes; within each window the live lanes (a non-zero direction)
move to the front in a stable order, optionally ordered by the Morton code
of their origins, the walk runs over the permuted front, and its hits go
back to their source lanes. Scheduling only: the hits are exactly the walk's
on the unpermuted front.

On the TPU a 1024-lane packet walks while any of its lanes is live, so
packing live lanes together let whole packets retire. On the H100 the unit
that walks on is a warp of 32 threads: compaction fills warps with live rays
and, with the Morton order, with rays of nearby origins. The permutation is
library data movement (`torch.sort` per window, gathers and one scatter per
dtype), as the JAX package's is XLA's `lax.sort`. Eager torch pays a pass
over the front per operation, so the Morton key takes the three axes
together and spreads its bits by a table lookup, and the restore moves t,
u and v together.

Layout: a 2D front whose sides are multiples of TILE is taken in the JAX
launcher's tile-major lane order (32x32 image tiles, one block each), so a
window is a run of horizontally adjacent tiles; any other front is taken
flat.
"""

from __future__ import annotations

import functools

import torch

from rust_renderer_tpu_torch.ops import traversal
from rust_renderer_tpu_torch.ops.traversal import BLOCK, TILE


def _spread10(x: torch.Tensor) -> torch.Tensor:
    """Interleave-ready bit spread of a 10-bit int32 (Morton helper)."""
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


@functools.cache
def _spread_table(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(3 * 1024,) int32 holding `_spread10(q) << k` at k * 1024 + q, and
    the (3,) offsets k * 1024, on `device`."""
    spread = _spread10(torch.arange(1024, dtype=torch.int32))
    table = torch.cat([spread << k for k in range(3)])
    offset = torch.tensor([0, 1024, 2048], dtype=torch.int32)
    return table.to(device), offset.to(device)


def _morton30(o: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """30-bit Morton code of each lane's origin ((N, 3) -> (N,) int32),
    each axis quantized over the live lanes' bounds. The float-to-int
    conversion saturates and takes NaN to 0, as XLA's does, before the clip
    to [0, 1023]. The three spread axes hold disjoint bits, so their sum is
    their OR."""
    big = 3e38
    lo = torch.where(live[:, None], o, big).amin(dim=0)
    hi = torch.where(live[:, None], o, -big).amax(dim=0)
    span = torch.clamp_min(hi - lo, 1e-12)
    x = (o - lo) / span * 1024.0
    q = x.nan_to_num(0.0).clamp(0.0, 1023.0).to(torch.int32)
    table, offset = _spread_table(o.device)
    return table[q + offset].sum(dim=1, dtype=torch.int32)


def _lane_maps(shape):
    """(pack, unpack) between a front of leading dims `shape` and its flat
    lane order: tile-major for a 2D front with sides that are multiples of
    TILE, row-major otherwise. pack takes (*shape, *rest) to (N, *rest);
    unpack takes (*lead, N) to (*lead, *shape)."""
    if len(shape) == 2 and shape[0] % TILE == 0 and shape[1] % TILE == 0:
        h, w = shape

        def pack(x):
            rest = x.shape[2:]
            x = x.reshape(h // TILE, TILE, w // TILE, TILE, *rest)
            return x.transpose(1, 2).reshape(-1, *rest)

        def unpack(x):
            lead = x.shape[:-1]
            x = x.reshape(*lead, h // TILE, w // TILE, TILE, TILE)
            return x.transpose(-3, -2).reshape(*lead, h, w)

        return pack, unpack
    nd = len(shape)
    return ((lambda x: x.reshape(-1, *x.shape[nd:])),
            (lambda x: x.reshape(*x.shape[:-1], *shape)))


def window_blocks_for(n: int, window_blocks: int) -> int:
    """The window, in blocks, for a front of `n` lanes: the largest divisor
    of the block count that is at most `window_blocks`; 1 (no compaction)
    for a front that is not whole blocks or has no divisor of at least 2
    (a 1080p front is 2,025 blocks: 64 -> 45, 128 -> 81)."""
    n_blocks = n // BLOCK
    if n % BLOCK:
        return 1
    for cand in range(min(window_blocks, n_blocks), 1, -1):
        if n_blocks % cand == 0:
            return cand
    return 1


def window_forward_map(live_flat: torch.Tensor, window_lanes: int) -> torch.Tensor:
    """src -> dst map (int64) of the stable live-first partition within each
    window. live_flat: (N,) bool, N a multiple of window_lanes."""
    lw = live_flat.reshape(-1, window_lanes)
    li = lw.to(torch.int64)
    nl = torch.cumsum(li, dim=1)
    nd = torch.cumsum(1 - li, dim=1)
    nlive = nl[:, -1:]
    pos = torch.where(lw, nl - 1, nlive + nd - 1)
    base = window_lanes * torch.arange(lw.shape[0], device=lw.device)[:, None]
    return (pos + base).reshape(-1)


def window_permutation(o: torch.Tensor, live: torch.Tensor, window: int,
                       order: str) -> torch.Tensor:
    """Per window, the source lanes in walk order (int64, (N,), flat lane
    indices): the stable sort of the key `dead` ("live") or
    `dead << 30 | morton30(origin)` ("morton") along each window, which is
    the JAX package's `lax.sort` of (key, source index)."""
    if order == "morton":
        code = _morton30(o, live)
        key = torch.where(live, code, code | (1 << 30))
    elif order == "live":
        key = (~live).to(torch.int32)
    else:
        raise ValueError(f"unknown compaction order {order!r}")
    _, src = torch.sort(key.reshape(-1, window), dim=1, stable=True)
    base = window * torch.arange(src.shape[0], device=src.device)[:, None]
    return (src + base).reshape(-1)


def traverse_compacted(bvh, origin, direction, t_min=1e-3, t_max=1e4,
                       window_blocks: int = 8, trav=None, method: str = "sort",
                       order: str = "live", **kw):
    """`trav` (default `traversal.traverse`) over the front permuted live
    lanes first within windows of `window_blocks` adjacent ray blocks
    (snapped by `window_blocks_for`), its hits restored to their lanes.
    Same results as `trav` on the unpermuted front; with `any_hit=True`
    only prim is restored, and t, u and v are zeros (the JAX package's
    occlusion form: its callers read `prim >= 0`).

    method "sort" permutes by `window_permutation` (order "live" or
    "morton") and restores by the source index; method "scatter" places
    lane i at `window_forward_map`'s slot and gathers the hits back (live
    first, no Morton order).
    """
    if trav is None:
        trav = traversal.traverse
    shape = origin.shape[:-1]
    n = shape.numel()
    wb = window_blocks_for(n, window_blocks)
    if wb < 2:
        return trav(bvh, origin, direction, t_min, t_max, **kw)
    window = wb * BLOCK
    dev = origin.device
    pack, unpack = _lane_maps(shape)
    o, d = pack(origin), pack(direction)
    # A sum of squares is positive exactly when one square is, in any order.
    live = (d * d).sum(dim=1) > 0.0
    # Per-lane limits move with their lanes; a float stays a float.
    per_lane = lambda x: torch.is_tensor(x) and x.dim() > 0
    limits = [pack(traversal.flat_limit(x, shape, dev).reshape(shape)) if per_lane(x) else x
              for x in (t_min, t_max)]

    if method == "sort":
        src = window_permutation(o, live, window, order)
        walk = lambda x: x[src]
    elif method == "scatter":
        src = window_forward_map(live, window)
        walk = lambda x: torch.empty_like(x).index_put_((src,), x)
    else:
        raise ValueError(f"unknown compaction method {method!r}")
    lims = [walk(x) if per_lane(x) else x for x in limits]
    t, prim, u, v = trav(bvh, walk(o), walk(d), lims[0], lims[1], **kw)

    def restore(x):
        """(C, N) hits in walk order -> (C, *shape), each at its lane."""
        if method == "sort":
            return unpack(torch.empty_like(x).index_copy_(1, src, x))
        return unpack(x[:, src])

    prim_o = restore(prim.reshape(1, n))[0]
    if kw.get("any_hit", False):
        zero = torch.zeros(shape, dtype=torch.float32, device=dev)
        return zero, prim_o, zero, zero
    t_o, u_o, v_o = restore(torch.stack([t.reshape(n), u.reshape(n), v.reshape(n)]))
    return t_o, prim_o, u_o, v_o
