"""Frame graph: passes as functions over named resources.

The port of the subset of ``rust_renderer_tpu/graph.py`` that the path-traced
graph needs (the reference's utopian/src/graph.rs + pass.rs). The graph is
recorded every frame (`new_frame`, `clear`, `add_pass(...)...build()`) over
resources cached by name; `render` runs the passes in order.

- A pass declares what it reads and writes. Its body sees only its declared
  reads: reading anything else raises a ValueError that names the resource,
  and so does writing an undeclared resource.
- A resource read before any pass of the frame wrote it holds its clear value
  (transient) or last frame's value (persistent). Persistent resources
  (accumulation image, reservoirs) live in `Graph.state` across frames.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping
from typing import Callable

import torch

from rust_renderer_tpu_torch.settings import RenderSettings


@dataclasses.dataclass
class ResourceDesc:
    """Named resource descriptor (graph.rs:563-619); `clear` is the value a
    fresh resource holds."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    clear: float = 0.0

    def allocate(self, device) -> torch.Tensor:
        return torch.full(self.shape, self.clear, dtype=self.dtype, device=device)


@dataclasses.dataclass
class RenderPass:
    """One recorded pass (pass.rs:14-30)."""

    name: str
    reads: list[str]
    writes: list[str]
    fn: Callable  # fn(resources, scene, view) -> dict of writes


class PassBuilder:
    """Fluent pass construction (graph.rs:120-416)."""

    def __init__(self, graph: "Graph", name: str):
        self._graph = graph
        self._name = name
        self._reads: list[str] = []
        self._writes: list[str] = []
        self._fn: Callable | None = None

    def read(self, resource: str) -> "PassBuilder":
        self._reads.append(resource)
        return self

    def write(self, resource: str) -> "PassBuilder":
        self._writes.append(resource)
        return self

    def render(self, fn: Callable) -> "PassBuilder":
        """The pass body: fn(resources, scene, view) -> {written_name: tensor}."""
        self._fn = fn
        return self

    def build(self) -> None:
        """Record into the graph (graph.rs:342-415)."""
        if self._fn is None:
            raise ValueError(f"pass '{self._name}' has no render fn")
        self._graph.passes.append(
            RenderPass(self._name, list(self._reads), list(self._writes), self._fn))


class _PassResources(Mapping):
    """The resources one pass may read. Resources the frame has not written
    yet are allocated at their clear value on first read."""

    def __init__(self, graph: "Graph", resources: dict, render_pass: RenderPass):
        self._graph = graph
        self._resources = resources
        self._pass = render_pass

    def __getitem__(self, name: str) -> torch.Tensor:
        if name not in self._pass.reads:
            raise ValueError(
                f"pass '{self._pass.name}' reads resource '{name}' without "
                "declaring it with .read()")
        if name not in self._resources:
            desc = self._graph.descs.get(name)
            if desc is None:
                raise ValueError(
                    f"pass '{self._pass.name}' reads resource '{name}', which "
                    "no create_texture/create_buffer declared")
            self._resources[name] = desc.allocate(self._graph.device)
        return self._resources[name]

    def __iter__(self):
        return iter(self._pass.reads)

    def __len__(self) -> int:
        return len(self._pass.reads)


class Graph:
    """The frame graph (graph.rs:99-106 + 440-1065) on one device."""

    def __init__(self, device="cpu") -> None:
        self.device = torch.device(device)
        self.passes: list[RenderPass] = []
        self.descs: dict[str, ResourceDesc] = {}
        self.persist: set[str] = set()
        self.state: dict[str, torch.Tensor] = {}
        self.current_frame = 0

    # -- per-frame recording (graph.rs:459-484) -----------------------------

    def new_frame(self) -> None:
        self.current_frame += 1

    def clear(self) -> None:
        self.passes = []

    # -- resources (graph.rs:563-635) ---------------------------------------

    def create_texture(self, name: str, width: int, height: int, channels: int = 4,
                       dtype=torch.float32, clear: float = 0.0,
                       persistent: bool = False) -> str:
        """Name-keyed texture cache (graph.rs:563-587). (H, W, C) layout."""
        shape = (height, width, channels) if channels > 1 else (height, width)
        return self._declare(name, shape, dtype, clear, persistent)

    def create_buffer(self, name: str, shape: tuple[int, ...], dtype=torch.float32,
                      clear: float = 0.0, persistent: bool = False) -> str:
        """graph.rs:593-619."""
        return self._declare(name, tuple(shape), dtype, clear, persistent)

    def _declare(self, name, shape, dtype, clear, persistent) -> str:
        desc = ResourceDesc(name, tuple(shape), dtype, clear)
        old = self.descs.get(name)
        if old is not None and (old.shape != desc.shape or old.dtype != desc.dtype):
            # A resolution change drops the cached resource.
            self.state.pop(name, None)
        self.descs[name] = desc
        if persistent:
            self.persist.add(name)
            if name not in self.state:
                self.state[name] = desc.allocate(self.device)
        return name

    def add_pass(self, name: str) -> PassBuilder:
        return PassBuilder(self, name)

    # -- execution ------------------------------------------------------------

    def render(self, scene, view) -> dict[str, torch.Tensor]:
        """Run the recorded passes in order. `view` (a host RenderSettings) is
        uploaded once. Returns every resource of the frame; persistent ones
        are kept in `state` for the next frame."""
        if isinstance(view, RenderSettings):
            view = view.to(self.device)
        resources: dict[str, torch.Tensor] = dict(self.state)
        for p in self.passes:
            outs = p.fn(_PassResources(self, resources, p), scene, view)
            for wname, arr in (outs or {}).items():
                if wname not in p.writes:
                    raise ValueError(
                        f"pass '{p.name}' writes resource '{wname}' without "
                        "declaring it with .write()")
                resources[wname] = arr
        self.state.update({n: resources[n] for n in self.persist if n in resources})
        return resources
