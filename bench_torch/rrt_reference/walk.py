"""Closest-hit and any-hit queries for the path-traced reference, which asks
some sixty of them of every 1080p frame it renders.

The answer is `trace.Tree.closest`'s: the closest hit of the Moller-Trumbore
test (`trace.intersect`), both faces, at a distance in (1e-3, 1e4), the
lower triangle index on a tie, nothing for a zero direction. Two things
make it quicker to find:

- the scene's large triangles (a box longer than `LARGE` on some axis: the
  floor, the walls, the caps) are tested against every ray by brute force,
  before the walk, and the tree holds only the others, so that its boxes
  stay tight and the walk starts with a bound on the distance;
- the walk takes the nearer child first and keeps the other on a stack of
  its own, skipping any node whose box begins beyond the nearest hit found.
"""

from __future__ import annotations

import torch

from rrt_reference.trace import T_MAX, T_MIN, Hit, Tree, intersect

LARGE = 1.0
# The tree of Sponza's small triangles has 2^16 leaves: at most 16 pushes.
STACK = 32
# Rays a brute-force pass over the large triangles holds at once.
CHUNK = 1 << 16


class Scene:
    def __init__(self, v: torch.Tensor):
        """v: (T, 3, 3) triangle corners."""
        extent = (v.max(dim=1).values - v.min(dim=1).values).amax(dim=1)
        large = extent > LARGE
        self.large = torch.nonzero(large).squeeze(1)
        self.large_v = v[self.large]
        self.small = torch.nonzero(~large).squeeze(1)
        self.tree = Tree(v[self.small])

    def query(self, origin: torch.Tensor, direction: torch.Tensor, any_hit=False) -> Hit:
        """origin, direction: (R, 3). `any_hit`, a bool or an (R,) bool
        tensor: where true, some hit (the ray's walk ends at its first),
        else the closest."""
        dev = origin.device
        r = origin.shape[0]
        best = Hit(torch.full((r,), float("inf"), device=dev),
                   torch.full((r,), -1, dtype=torch.int64, device=dev),
                   torch.zeros(r, device=dev), torch.zeros(r, device=dev))
        ids = torch.nonzero(direction.ne(0).any(dim=1)).squeeze(1)
        if not ids.numel():
            return best
        o, d = origin[ids], direction[ids]
        any_hit = torch.as_tensor(any_hit, device=dev).expand(r)[ids]
        bt, bp = best.t[ids], best.prim[ids]
        bu, bv = best.u[ids], best.v[ids]
        if self.large.numel():
            for c in range(0, ids.numel(), CHUNK):
                s = slice(c, c + CHUNK)
                bt[s], bp[s], bu[s], bv[s] = self._brute(o[s], d[s], bt[s], bp[s], bu[s], bv[s])
        if self.small.numel():
            todo = torch.nonzero(~any_hit | (bp < 0)).squeeze(1)
            self._walk(todo, o, d, bt, bp, bu, bv, any_hit)
        best.t[ids], best.prim[ids], best.u[ids], best.v[ids] = bt, bp, bu, bv
        return best

    def _brute(self, o, d, bt, bp, bu, bv):
        """Every ray against every large triangle."""
        lv = self.large_v
        n = lv.shape[0]
        t, u, v, ok = intersect(o[:, None].expand(-1, n, -1), d[:, None].expand(-1, n, -1),
                                lv[None, :, 0], lv[None, :, 1], lv[None, :, 2])
        # The lowest index among the nearest: large indices rise with k.
        k = torch.argmin(t, dim=1)
        tk = t.gather(1, k[:, None]).squeeze(1)
        pk = self.large[k]
        better = ok.any(dim=1) & ((tk < bt) | ((tk == bt) & (pk < bp)))
        return (torch.where(better, tk, bt), torch.where(better, pk, bp),
                torch.where(better, u.gather(1, k[:, None]).squeeze(1), bu),
                torch.where(better, v.gather(1, k[:, None]).squeeze(1), bv))

    def _walk(self, todo, o, d, bt, bp, bu, bv, any_hit):
        """The small triangles' tree, walked for the rays `todo` (indices
        into o, d, any_hit and the bests, which it updates in place). The rays still
        walking are kept packed, with their own copies of the bests, and
        written back as they finish."""
        tree = self.tree
        dev = o.device
        slots = torch.arange(4, device=dev)
        pair = torch.tensor([0, 1], device=dev)
        never = torch.iinfo(torch.int64).max

        def near_far(node, oo, inv, t_best):
            """(entry distance, entered) of the boxes `node` (R, k)."""
            t1 = (tree.lo[node] - oo[:, None]) * inv[:, None]
            t2 = (tree.hi[node] - oo[:, None]) * inv[:, None]
            near = torch.minimum(t1, t2).amax(dim=2).clamp(min=T_MIN)
            far = torch.maximum(t1, t2).amin(dim=2)
            far = torch.minimum(far, torch.clamp(t_best, max=T_MAX)[:, None])
            return near, (near <= far) & tree.live[node]

        oo, dd = o[todo], d[todo]
        inv = 1.0 / torch.where(dd == 0, torch.full_like(dd, 1e-30), dd)
        t_b, p_b, u_b, v_b = bt[todo], bp[todo], bu[todo], bv[todo]
        any_b = any_hit[todo]
        root = torch.ones((todo.numel(), 1), dtype=torch.int64, device=dev)
        node = torch.where(near_far(root, oo, inv, t_b)[1][:, 0], 1, 0)
        stack = torch.zeros((todo.numel(), STACK), dtype=torch.int64, device=dev)
        stack_t = torch.zeros((todo.numel(), STACK), device=dev)
        sp = torch.zeros(todo.shape, dtype=torch.int64, device=dev)
        step = 0
        while todo.numel():
            # A node taken from the stack is skipped if its box begins
            # beyond the nearest hit found since it was pushed.
            pop = (node == 0) & (sp > 0)
            sp = sp - pop.long()
            at = sp.clamp(min=0)[:, None]
            top, top_t = stack.gather(1, at).squeeze(1), stack_t.gather(1, at).squeeze(1)
            node = torch.where(pop & (top_t <= t_b), top, node)
            leaf = node >= tree.leaves
            test = torch.nonzero(leaf).squeeze(1)
            if test.numel():
                slot = (node[test] - tree.leaves)[:, None] * 4 + slots
                tri = tree.slot_v[slot]
                t, u, v, ok = intersect(oo[test, None].expand(-1, 4, -1),
                                        dd[test, None].expand(-1, 4, -1),
                                        tri[:, :, 0], tri[:, :, 1], tri[:, :, 2])
                prim = self.small[tree.slot_prim[slot].clamp(min=0)]
                # The lowest index among the leaf's nearest: the tree keeps
                # a leaf's triangles in Morton order, not by index.
                tmin = t.amin(dim=1, keepdim=True)
                k = torch.argmin(torch.where(ok & (t == tmin), prim, never), dim=1)
                tk = tmin.squeeze(1)
                pk = prim.gather(1, k[:, None]).squeeze(1)
                cur_t, cur_p = t_b[test], p_b[test]
                better = ok.any(dim=1) & ((tk < cur_t) | ((tk == cur_t) & (pk < cur_p)))
                t_b[test] = torch.where(better, tk, cur_t)
                p_b[test] = torch.where(better, pk, cur_p)
                u_b[test] = torch.where(better, u.gather(1, k[:, None]).squeeze(1), u_b[test])
                v_b[test] = torch.where(better, v.gather(1, k[:, None]).squeeze(1), v_b[test])
            inner = (node > 0) & ~leaf
            kids = torch.where(inner, node * 2, 0)[:, None] + pair
            near, enter = near_far(kids, oo, inv, t_b)
            enter = enter & inner[:, None]
            e0, e1 = enter[:, 0], enter[:, 1]
            first = e0 & (~e1 | (near[:, 0] <= near[:, 1]))
            push = e0 & e1
            at = sp.clamp(max=STACK - 1)[:, None]
            other = torch.where(first, kids[:, 1], kids[:, 0])
            other_t = torch.where(first, near[:, 1], near[:, 0])
            stack.scatter_(1, at, torch.where(push, other, stack.gather(1, at).squeeze(1))[:, None])
            stack_t.scatter_(1, at, torch.where(push, other_t,
                                                stack_t.gather(1, at).squeeze(1))[:, None])
            sp = sp + push.long()
            node = torch.where(first, kids[:, 0], torch.where(e1, kids[:, 1], 0))
            step += 1
            if step % 4 == 0:
                done = ((node == 0) & (sp == 0)) | (any_b & (p_b >= 0))
                if bool(done.any()):
                    out = todo[done]
                    bt[out], bp[out], bu[out], bv[out] = t_b[done], p_b[done], u_b[done], v_b[done]
                    keep = ~done
                    todo, node, sp, stack, stack_t = (todo[keep], node[keep], sp[keep],
                                                      stack[keep], stack_t[keep])
                    oo, dd, inv, any_b = oo[keep], dd[keep], inv[keep], any_b[keep]
                    t_b, p_b, u_b, v_b = t_b[keep], p_b[keep], u_b[keep], v_b[keep]
