"""Closest-hit ray queries against the scene's triangles.

A ray hits a triangle by the Moller-Trumbore test, both faces, at a
distance in (1e-3, 1e4); the closest hit wins, and of two at the same
distance the lower triangle index. A ray with a zero direction hits
nothing.

The tree is the plainest that serves: triangles in the Morton order of
their centroids, four to a leaf, leaves padded to a power of two, and a
complete binary tree of boxes above them in heap order (node n has the
children 2n and 2n + 1, the leaves are nodes L .. 2L - 1). Each ray walks
it left child first without a stack: from a node that is done, the next
is (n + 1) divided by its lowest set bit, and the walk ends where that is
the root."""

from __future__ import annotations

import dataclasses

import torch

LEAF = 4
T_MIN, T_MAX = 1e-3, 1e4


@dataclasses.dataclass
class Hit:
    t: torch.Tensor  # (R,) inf on a miss
    prim: torch.Tensor  # (R,) int64, -1 on a miss
    u: torch.Tensor  # (R,) barycentric weight of the second corner
    v: torch.Tensor  # (R,) ... of the third

    @property
    def is_hit(self) -> torch.Tensor:
        return self.prim >= 0


def _spread_bits(x: torch.Tensor) -> torch.Tensor:
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    return (x | (x << 2)) & 0x09249249


class Tree:
    def __init__(self, v: torch.Tensor):
        """v: (T, 3, 3) triangle corners."""
        dev = v.device
        t = v.shape[0]
        c = v.mean(dim=1)
        lo, hi = c.min(dim=0).values, c.max(dim=0).values
        q = ((c - lo) / torch.clamp(hi - lo, min=1e-12) * 1023.0).long().clamp(0, 1023)
        code = (_spread_bits(q[:, 0]) << 2) | (_spread_bits(q[:, 1]) << 1) | _spread_bits(q[:, 2])
        order = torch.argsort(code, stable=True)
        leaves = 1
        while leaves * LEAF < t:
            leaves *= 2
        self.leaves = leaves
        slots = torch.full((leaves * LEAF,), -1, dtype=torch.int64, device=dev)
        slots[:t] = order
        self.slot_prim = slots
        corners = torch.zeros(leaves * LEAF, 3, 3, device=dev)
        corners[:t] = v[order]
        self.slot_v = corners
        inf = torch.full((leaves * LEAF, 3), float("inf"), device=dev)
        box_lo = torch.where((slots >= 0)[:, None], corners.min(dim=1).values, inf)
        box_hi = torch.where((slots >= 0)[:, None], corners.max(dim=1).values, -inf)
        lo_nodes = torch.zeros(2 * leaves, 3, device=dev)
        hi_nodes = torch.zeros(2 * leaves, 3, device=dev)
        lo_nodes[leaves:] = box_lo.view(leaves, LEAF, 3).min(dim=1).values
        hi_nodes[leaves:] = box_hi.view(leaves, LEAF, 3).max(dim=1).values
        width = leaves
        while width > 1:
            width //= 2
            kids_lo = lo_nodes[2 * width:4 * width].view(width, 2, 3)
            kids_hi = hi_nodes[2 * width:4 * width].view(width, 2, 3)
            lo_nodes[width:2 * width] = kids_lo.min(dim=1).values
            hi_nodes[width:2 * width] = kids_hi.max(dim=1).values
        self.lo, self.hi = lo_nodes, hi_nodes
        # Node 0 stands for a finished walk; empty boxes (the padding) are never entered.
        self.live = (lo_nodes[:, 0] <= hi_nodes[:, 0]) & (torch.arange(2 * leaves, device=dev) > 0)

    def closest(self, origin: torch.Tensor, direction: torch.Tensor,
                any_hit: bool = False) -> Hit:
        """origin, direction: (R, 3). With `any_hit` a ray's walk ends at
        its first hit, which is then some hit, not the closest."""
        dev = origin.device
        r = origin.shape[0]
        best_t = torch.full((r,), float("inf"), device=dev)
        best_p = torch.full((r,), -1, dtype=torch.int64, device=dev)
        best_u = torch.zeros(r, device=dev)
        best_v = torch.zeros(r, device=dev)
        ids = torch.nonzero(direction.ne(0).any(dim=1)).squeeze(1)
        o, d = origin[ids], direction[ids]
        inv = 1.0 / torch.where(d == 0, torch.full_like(d, 1e-30), d)
        node = torch.ones(ids.shape[0], dtype=torch.int64, device=dev)
        bt, bp = best_t[ids], best_p[ids]
        bu, bv = best_u[ids], best_v[ids]
        step = 0
        while ids.numel():
            t1 = (self.lo[node] - o) * inv
            t2 = (self.hi[node] - o) * inv
            near = torch.minimum(t1, t2).amax(dim=1).clamp(min=T_MIN)
            far = torch.maximum(t1, t2).amin(dim=1)
            far = torch.minimum(far, torch.minimum(bt, torch.full_like(bt, T_MAX)))
            enter = (near <= far) & self.live[node]
            leaf = node >= self.leaves
            test = torch.nonzero(enter & leaf).squeeze(1)
            if test.numel():
                base = (node[test] - self.leaves) * LEAF
                for k in range(LEAF):
                    slot = base + k
                    tri = self.slot_v[slot]
                    t, u, v, ok = intersect(o[test], d[test], tri[:, 0], tri[:, 1], tri[:, 2])
                    prim = self.slot_prim[slot]
                    cur_t, cur_p = bt[test], bp[test]
                    better = ok & ((t < cur_t) | ((t == cur_t) & (prim < cur_p)))
                    bt[test] = torch.where(better, t, cur_t)
                    bp[test] = torch.where(better, prim, cur_p)
                    bu[test] = torch.where(better, u, bu[test])
                    bv[test] = torch.where(better, v, bv[test])
            descend = enter & ~leaf
            if any_hit:
                descend = descend & (bp < 0)
            nxt = node + 1
            nxt = nxt // (nxt & -nxt)
            nxt = torch.where((nxt == 1) | (node == 0), torch.zeros_like(nxt), nxt)
            if any_hit:
                nxt = torch.where(bp >= 0, torch.zeros_like(nxt), nxt)
            node = torch.where(descend, node * 2, nxt)
            step += 1
            if step % 4 == 0:
                done = node == 0
                if done.any():
                    out = ids[done]
                    best_t[out], best_p[out], best_u[out], best_v[out] = \
                        bt[done], bp[done], bu[done], bv[done]
                    keep = ~done
                    ids, o, d, inv, node = ids[keep], o[keep], d[keep], inv[keep], node[keep]
                    bt, bp, bu, bv = bt[keep], bp[keep], bu[keep], bv[keep]
        return Hit(best_t, best_p, best_u, best_v)


def intersect(o, d, v0, v1, v2):
    """Moller-Trumbore, both faces: (t, u, v, hit); t is inf on a miss."""
    e1 = v1 - v0
    e2 = v2 - v0
    pvec = torch.cross(d, e2, dim=-1)
    det = (e1 * pvec).sum(-1)
    ok = det.abs() > 1e-12
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                          torch.zeros_like(det))
    tvec = o - v0
    u = (tvec * pvec).sum(-1) * inv_det
    qvec = torch.cross(tvec, e1, dim=-1)
    v = (d * qvec).sum(-1) * inv_det
    t = (e2 * qvec).sum(-1) * inv_det
    hit = ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > T_MIN) & (t < T_MAX)
    return torch.where(hit, t, torch.full_like(t, float("inf"))), u, v, hit
