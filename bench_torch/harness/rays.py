"""The harness's count of the rays each traversal call walks.

A wrapper around the program's traversal entry (`ops/traversal.py::
traverse`) adds, on the device, the number of live rays of each call (a
ray whose direction is not zero: the walk retires a zero direction on
entry) to one of two counters, closest-hit and any-hit. The additions are
device work of the frame, so a captured frame's replays count too; the
counters are read once, after the traced window."""

from __future__ import annotations

import torch

CLOSEST, ANY_HIT = 0, 1


class RayCounter:
    def __init__(self, traversal_module, device):
        self.live = torch.zeros(2, dtype=torch.int64, device=device)
        self._module = traversal_module
        self._inner = traversal_module.traverse
        traversal_module.traverse = self._traverse

    def _traverse(self, bvh, origin, direction, *args, **kw):
        # traverse(bvh, origin, direction, t_min, t_max, any_hit, ...)
        any_hit = kw.get("any_hit", args[2] if len(args) > 2 else False)
        live = direction.reshape(-1, 3).ne(0).any(dim=1).sum()
        self.live[ANY_HIT if any_hit else CLOSEST].add_(live)
        return self._inner(bvh, origin, direction, *args, **kw)

    def reset(self) -> None:
        self.live.zero_()

    def read(self) -> tuple[int, int]:
        """(closest-hit rays, any-hit rays) since the last reset."""
        c, a = self.live.tolist()
        return int(c), int(a)

    def remove(self) -> None:
        self._module.traverse = self._inner
