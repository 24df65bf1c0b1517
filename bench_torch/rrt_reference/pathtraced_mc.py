"""The path-traced frame with the animated isosurface (BASELINE config 5):
`pathtraced`'s frame, with the surface of `marching_cubes` in the traced
scene.

Each frame extracts the surface anew at its own time (`unit.time(k)`, the
program's float32 clock) and adds its live triangles to the scene: every
closest-hit and any-hit query, of the g-buffer, of each bounce and of both
occlusion rays, walks the atrium and the surface, and the nearer hit wins;
of two at the same distance, the atrium's. A surface hit shades as the
renderer's isosurface material does: Lambertian, green (0, 1, 0), its
normal the surface's gradient normals interpolated at the hit by its
barycentrics, normalized and turned toward the incident ray, untextured.
The g-buffer keeps a surface hit's position, as it does any hit's.

How it departs from the renderer, where it does:
- the surface's triangles join the atrium's tables behind them (their
  index is the atrium's count plus their place among the live slots), so
  that `pathtraced`'s queries, its re-taking of t, u and v on the hit
  triangle and its scattering serve both; the renderer refits a tree of
  its own over every slot, live or not, and merges the two walks' hits
  (the same hits, a different tree);
- the surface's tree is `trace.Tree` over the live triangles, built anew
  each frame, where the renderer refits a static-topology width-16 tree;
- under the bf16 control the extraction's positions and normals are kept
  in bfloat16 too, as the outputs of the renderer's extraction pass.

`Reference` keeps what `pathtraced.Reference` keeps (the sample count,
the previous P·V) and renders a unit one frame at a time, each frame from
the state the last left, in `pathtraced`'s row blocks."""

from __future__ import annotations

import dataclasses

import torch

from rrt_reference import camera as cam, marching_cubes as mc, pathtraced, walk
from rrt_reference.trace import Hit, Tree

# builder -> (the scene builder it frames, the eye, the target): the atrium
# seen from inside, looking up over its +z wall at the surface's shapes.
VIEWS = {"create_sponza_scale_mc_scene": ("create_sponza_scale_scene", [2.0, 3.0, 1.0],
                                          [10.0, 12.0, 10.0])}


class TwoTrees:
    """The atrium's queries and the surface's, merged: the nearer hit wins,
    and a tie goes to the atrium. A surface hit's index is `offset` plus
    its place among the surface's triangles. The surface's tree answers
    every query with the closest hit, which is also some hit where only
    some hit is asked for."""

    def __init__(self, atrium: walk.Scene, surface_v: torch.Tensor, offset: int):
        self.atrium = atrium
        self.surface = Tree(surface_v) if surface_v.shape[0] else None
        self.offset = offset

    def query(self, origin, direction, any_hit=False) -> Hit:
        hit = self.atrium.query(origin, direction, any_hit)
        if self.surface is None:
            return hit
        s = self.surface.closest(origin, direction)
        near = s.is_hit & (s.t < hit.t)
        return Hit(torch.where(near, s.t, hit.t), torch.where(near, s.prim + self.offset, hit.prim),
                   torch.where(near, s.u, hit.u), torch.where(near, s.v, hit.v))


class Reference(pathtraced.Reference):
    """The reference renderer of a configuration with the isosurface on."""

    def __init__(self, config: dict, device, size: dict | None = None):
        size = size or {}
        static = {**config.get("static_config", {}), **size.get("static_config", {})}
        self.grid = int(static.get("mc_grid", 32))
        if not config.get("view", {}).get("marching_cubes_enabled"):
            raise ValueError("this reference renders the path-traced frame with the isosurface")
        builder, eye, target = VIEWS[config["builder"]]
        # float32 throughout: no matmul of the frame may round through TF32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        super().__init__({**config, "builder": builder,
                          "view": {**config["view"], "marching_cubes_enabled": 0}},
                         device, size)
        self.atrium = dataclasses.replace(self.scene, eye=eye, target=target)
        self.atrium_geometry = self.geometry
        self.camera = cam.Camera(eye, target, self.width / self.height)
        # scene.build's last material: the isosurface's.
        self.surface_material = int(self.atrium.mat_base_color.shape[0]) - 1

    def set_surface(self, time) -> None:
        """The scene and the queries of a frame at `time`: the atrium with
        the surface's live triangles behind its own."""
        pos, nrm, live = mc.extract(time, self.grid, self.device)
        pos, nrm = self._out(pos), self._out(nrm)
        keep = torch.nonzero(live).squeeze(1)
        v, n = pos[keep], nrm[keep]
        a = self.atrium
        self.scene = dataclasses.replace(
            a, v=torch.cat([a.v, v]), n=torch.cat([a.n, n]),
            uv=torch.cat([a.uv, a.uv.new_zeros((keep.numel(), 3, 2))]),
            material=torch.cat([a.material, a.material.new_full((keep.numel(),),
                                                                 self.surface_material)]))
        self.geometry = TwoTrees(self.atrium_geometry, v, a.v.shape[0])

    def render(self, before: dict) -> dict:
        """The unit's frames from `before`, one at a time, each with its own
        surface and from the state the last one left."""
        frames, state, out = self.frames, before, None
        try:
            for frame in frames:
                self.frames = [frame]
                self.set_surface(frame[1])
                out = super().render(state)
                state = {k: torch.from_numpy(v) for k, v in out.items()
                         if k not in ("image", "pt_rays")}
        finally:
            self.frames = frames
        return out
