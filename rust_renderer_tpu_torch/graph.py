"""Frame graph: passes as functions over named resources.

The port of the subset of ``rust_renderer_tpu/graph.py`` that the port's
graphs need (the reference's utopian/src/graph.rs + pass.rs). The graph is
recorded every frame (`new_frame`, `clear`, `add_pass(...)...build()`) over
resources cached by name; `render` runs the passes in order, and
`render_loop` runs N frames of them with the view advanced on the device
(on CUDA, replays of one captured CUDA graph of the frame).

- A pass declares what it reads and writes. Its body sees only its declared
  reads: reading anything else raises a ValueError that names the resource,
  and so does writing an undeclared resource.
- A resource read before any pass of the frame wrote it holds its clear value
  (transient) or last frame's value (persistent). Persistent resources
  (accumulation image, reservoirs) live in `Graph.state` across frames.
- `Graph(sanitize=True)` is the validation-layer analog (the JAX package's
  graph.py:154-175): the non-finite values of every floating pass output
  are counted on the device and read with one copy a frame (or one a
  `render_loop` call) into `last_sanitizer_report`.
- Every pass runs inside the profiler's span `pass/<name>` (the
  reference's per-pass GPU scope, graph.rs:1083-1125): its host enqueue
  time and, on CUDA, its device time, in a captured loop from the replays
  (utils/profiler.py).
- Hot reload (graph.rs:673-701): `recompile_shader(module)` reloads a
  kernel module; a pass that then fails falls back to the pass function of
  the last good frame.
- `shard_image_rows(group, height, width)` splits the image over the ranks
  of a torch.distributed group: image-space resources hold this rank's row
  band, and the passes read `Graph.band` (parallel/tiles.py::RowBand).
- Pass uniforms (graph.rs:307-340; the JAX package's traced pytree argument):
  `PassBuilder.uniforms(name, value)` writes the value into a device buffer
  that the graph keeps per (pass, name, shape, dtype) across rebuilds, and a
  body `fn(resources, scene, view, uniforms)` reads it there. A frame's
  values travel in one host-to-device copy (`prepare`), and a captured loop
  replays with new values as long as the structure stays the same.
"""

from __future__ import annotations

import dataclasses
import enum
import functools
import importlib
import inspect
import logging
import sys
import types
from collections.abc import Mapping
from typing import Any, Callable

import numpy as np
import torch
import torch.distributed

from rust_renderer_tpu_torch.settings import RenderSettings, to_tensor
from rust_renderer_tpu_torch.utils.profiler import PROFILER

log = logging.getLogger(__name__)
PACKAGE = __name__.rpartition(".")[0]

TextureId = str
BufferId = str


@dataclasses.dataclass
class ResourceDesc:
    """Named resource descriptor (graph.rs:563-619); `clear` is the value a
    fresh resource holds. sanitize=False exempts the resource from the
    sanitizer: for float tables whose columns hold bit-cast int32 ids, where
    -1 and other ids are NaN bit patterns."""

    name: str
    shape: tuple[int, ...]
    dtype: torch.dtype
    clear: float = 0.0
    sanitize: bool = True
    image: bool = False  # image-space: row-banded in a sharded graph

    def allocate(self, *, device) -> torch.Tensor:
        return torch.full(self.shape, self.clear, dtype=self.dtype, device=device)


@dataclasses.dataclass
class RenderPass:
    """One recorded pass (pass.rs:14-30). `uniforms` maps each uniform's name
    to the graph's device buffer that holds its value (read-only)."""

    name: str
    reads: list[str]
    writes: list[str]
    uniforms: Mapping[str, torch.Tensor]
    fn: Callable  # fn(resources, scene, view[, uniforms]) -> dict of writes
    isolated: bool = False  # see PassBuilder.isolate
    # Whether fn takes the uniforms: decided once, from fn's parameters.
    takes_uniforms: bool = dataclasses.field(init=False)

    def __post_init__(self) -> None:
        self.takes_uniforms = _takes_uniforms(self.fn)


class PassBuilder:
    """Fluent pass construction (graph.rs:120-416)."""

    def __init__(self, graph: "Graph", name: str):
        self._graph = graph
        self._name = name
        self._reads: list[str] = []
        self._writes: list[str] = []
        self._uniforms: dict[str, Any] = {}
        self._fn: Callable | None = None
        self._isolated = False

    def isolate(self) -> "PassBuilder":
        """Mark the pass isolated, as the JAX package's builders do (there:
        its own XLA program). `render` runs it like any other pass;
        `render_loop` runs a leading run of isolated passes for all N frames
        first and stacks what they write (`Graph.render_loop`)."""
        self._isolated = True
        return self

    def read(self, resource: str) -> "PassBuilder":
        self._reads.append(resource)
        return self

    def write(self, resource: str) -> "PassBuilder":
        self._writes.append(resource)
        return self

    # The reference's write kinds (graph.rs:146-208) are one write here.
    image_write = write
    write_buffer = write
    load_write = write

    def read_buffer(self, resource: str) -> "PassBuilder":
        return self.read(resource)

    def uniforms(self, name: str, value) -> "PassBuilder":
        """Per-pass uniform data (graph.rs:307-340): a number, a numpy array
        or a tensor (float64 and int64 values become float32 and int32, as
        in the JAX package). `build` writes it into the graph's device
        buffer for (pass, name, shape, dtype); the body reads that buffer."""
        self._uniforms[name] = value
        return self

    def render(self, fn: Callable) -> "PassBuilder":
        """The pass body: fn(resources, scene, view, uniforms) (the JAX
        package's form) or fn(resources, scene, view) -> {written_name:
        tensor}."""
        self._fn = fn
        return self

    dispatch = render
    trace_rays = render

    def presentation_pass(self, *_args, **_kw) -> "PassBuilder":
        return self

    def build(self) -> None:
        """Record into the graph (graph.rs:342-415)."""
        if self._fn is None:
            raise ValueError(f"pass '{self._name}' has no render fn")
        uniforms = {name: self._graph._uniforms.write(self._name, name, value)
                    for name, value in self._uniforms.items()}
        self._graph.passes.append(
            RenderPass(self._name, list(self._reads), list(self._writes),
                       types.MappingProxyType(uniforms), self._fn, self._isolated))


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
            self._resources[name] = desc.allocate(device=self._graph.device)
        return self._resources[name]

    def __iter__(self):
        return iter(self._pass.reads)

    def __len__(self) -> int:
        return len(self._pass.reads)


class Graph:
    """The frame graph (graph.rs:99-106 + 440-1065) on one device."""

    def __init__(self, sanitize: bool = False, suppress: tuple[str, ...] = (), *,
                 device="cuda") -> None:
        """sanitize=True counts the non-finite values of the passes' floating
        outputs and logs the nonzero counts by (pass, resource), except for
        the passes named in `suppress` (the analog of the reference's
        suppressed validation message, vulkan_base.rs:55-58). The resources
        and uniforms live on `device`."""
        self.device = torch.device(device)
        self._uniforms = _UniformStore(self.device)
        self.sanitize = bool(sanitize)
        self.suppress = tuple(suppress)
        self.last_sanitizer_report: dict[str, int] = {}
        # Hot reload: the generation grows with each reload; per pass name,
        # the function of the last frame it ran in without fault and the
        # generation then.
        self._generation = 0
        self._last_good: dict[str, tuple[Callable, bool, int]] = {}
        self.passes: list[RenderPass] = []
        self.descs: dict[str, ResourceDesc] = {}
        self.persist: set[str] = set()
        self.state: dict[str, torch.Tensor] = {}
        self.current_frame = 0
        # How the last render_loop ran its main body: "captured" (replays of
        # a CUDA graph) or "eager: <reason>".
        self.last_loop_form: str | None = None
        self.captures = 0  # CUDA graphs captured by render_loop
        self._loop: _Loop | None = None  # the captured loop render_loop replays
        self.band = None  # this rank's RowBand of a row-sharded graph

    def shard_image_rows(self, group, height: int, width: int | None = None,
                         axis: str = "rows") -> None:
        """Split the image into row bands over the ranks of `group` (a
        torch.distributed process group; the JAX package's mesh, whose only
        axis here is "rows"): from now on every image-space resource is
        declared and carried as this rank's (height / n, width, ...) band,
        and image-space state already held is cut to the band. Image-space
        resources are the textures (`create_texture`) and the buffers
        declared with image=True (the reservoir planes and their p_hat), and
        not any resource whose leading dims happen to be (height, width)
        (the JAX package's predicate): here the band changes what is
        allocated and held, so a square light-space table such as the BRDF
        LUT must never be taken for the image. Light-space resources (shadow
        cascades, cubemaps, the BRDF LUT) stay whole.

        Passes read `band`, this rank's row offset, its rows, the image's
        size and the gather of a band to the whole image (`offset`, `rows`,
        `full_height`, `width`, `gather`):
        per-pixel passes compute their band's rows in image coordinates,
        SSAO and FXAA gather the plane they shift to full height for the
        rows beyond the band's edges, and the rasterized draws rasterize the
        whole frame and keep their band. `render_loop` runs a sharded graph
        too, its collectives in every frame: captured over NCCL, eagerly
        over other backends (`capture_unsupported_reason`)."""
        from rust_renderer_tpu_torch.parallel.tiles import RowBand

        if axis != "rows":
            raise ValueError(f"a graph is sharded over image rows only, not {axis!r}")
        if self.band is not None:
            raise ValueError("the graph is row-sharded already")
        self.band = RowBand.of(group, height, width)
        for name, desc in self.descs.items():
            if desc.image:
                desc.shape = self._band_shape(name, desc.shape)
                if name in self.state:
                    start = self.band.offset
                    self.state[name] = self.state[name][start:start + self.band.rows].clone()

    def _band_shape(self, name: str, shape: tuple[int, ...]) -> tuple[int, ...]:
        """This rank's band of the image-space shape (H, W, ...)."""
        band = self.band
        if shape[0] != band.full_height or (band.width is not None and shape[1] != band.width):
            raise ValueError(f"image-space resource {name!r} of shape {shape} is not "
                             f"the sharded image's ({band.full_height}, {band.width})")
        return (band.rows, *shape[1:])

    # -- per-frame recording (graph.rs:459-484) -----------------------------

    def new_frame(self) -> None:
        self.current_frame += 1

    def clear(self) -> None:
        self.passes = []

    # -- resources (graph.rs:563-635) ---------------------------------------

    def create_texture(self, name: str, width: int, height: int, channels: int = 4,
                       dtype=torch.float32, clear: float = 0.0,
                       persistent: bool = False, sanitize: bool = True) -> str:
        """Name-keyed texture cache (graph.rs:563-587). (H, W, C) layout."""
        shape = (height, width, channels) if channels > 1 else (height, width)
        return self._declare(name, shape, dtype, clear, persistent, sanitize, image=True)

    def create_buffer(self, name: str, shape: tuple[int, ...], dtype=torch.float32,
                      clear: float = 0.0, persistent: bool = False,
                      sanitize: bool = True, image: bool = False) -> str:
        """graph.rs:593-619. image=True marks an (H, W, ...) image-space
        buffer, which a row-sharded graph bands (`shard_image_rows`)."""
        return self._declare(name, tuple(shape), dtype, clear, persistent, sanitize, image)

    def _declare(self, name, shape, dtype, clear, persistent, sanitize=True,
                 image=False) -> str:
        shape = tuple(shape)
        if self.band is not None and image:
            shape = self._band_shape(name, shape)
        desc = ResourceDesc(name, shape, dtype, clear, sanitize, image)
        old = self.descs.get(name)
        if old is not None and (old.shape != desc.shape or old.dtype != desc.dtype):
            # A resolution change drops the cached resource.
            self.state.pop(name, None)
        self.descs[name] = desc
        if persistent:
            self.persist.add(name)
            if name not in self.state:
                self.state[name] = desc.allocate(device=self.device)
        return name

    def add_pass(self, name: str) -> PassBuilder:
        return PassBuilder(self, name)

    def prepare(self) -> None:
        """Allocate any missing persistent resources on the graph's device
        (the lazy part of graph.rs:637-671), and copy the uniform values that
        the passes built since the last call wrote to the device in one
        copy. `render` and `render_loop` call it first."""
        for name in self.persist:
            if name not in self.state:
                self.state[name] = self.descs[name].allocate(device=self.device)
        self._uniforms.upload()

    # -- hot reload (graph.rs:673-701) ----------------------------------------

    def recompile(self) -> None:
        """Start a new generation after a reload: a pass that fails from now
        on falls back to its function of the last good frame, and the
        captured loop is dropped, so the next `render_loop` captures anew."""
        self._generation += 1
        self._loop = None

    def recompile_shader(self, module_name: str) -> bool:
        """Reload one kernel module by name (the reference's per-path shader
        recompile, graph.rs:683-701), then `recompile`. A module that
        declares native libraries declares them anew (`native.declare`), so
        its next launch loads the libraries of the sources as they stand.
        Returns whether the reload succeeded; a failed one keeps the old
        module."""
        mod = sys.modules.get(module_name)
        if mod is None:
            log.warning("recompile_shader: module %s not loaded", module_name)
            return False
        try:
            importlib.reload(mod)
        except Exception:
            log.exception("recompile_shader: reload of %s failed; keeping the old one",
                          module_name)
            return False
        self.recompile()
        return True

    def recompile_all_shaders(self) -> None:
        """Reload every loaded module of the port's ops and renderers."""
        for name, mod in list(sys.modules.items()):
            if name.startswith((f"{PACKAGE}.ops", f"{PACKAGE}.renderers")):
                try:
                    importlib.reload(mod)
                except Exception:
                    log.exception("reload of %s failed; keeping the old one", name)
        self.recompile()

    # -- execution ------------------------------------------------------------

    def _run_passes(self, passes, resources: dict, scene, view, count=None,
                    fell_back: set | None = None, spans: list | None = None) -> dict:
        """Run `passes` in order over `resources` (updated in place), each
        inside its profiler span `pass/<name>` (`spans`: where a captured
        span's event pair goes); `count(pass, name, tensor)` sees each output,
        outside the span. With `fell_back` (a set), a pass that raises after
        a reload runs its function of the last good frame instead, in the
        same span, and its name is added to the set."""
        for p in passes:
            with PROFILER.scope(f"pass/{p.name}", device=self.device, spans=spans):
                try:
                    outs = _call(p.fn, p.takes_uniforms, _PassResources(self, resources, p),
                                 scene, view, p.uniforms)
                except Exception:
                    old = self._last_good.get(p.name)
                    if fell_back is None or old is None or old[2] == self._generation:
                        raise  # no reload since the pass last ran: a fault to surface
                    log.exception("pass '%s' failed after a hot reload; running its "
                                  "function of the last good frame", p.name)
                    outs = _call(old[0], old[1], _PassResources(self, resources, p), scene,
                                 view, p.uniforms)
                    fell_back.add(p.name)
            for wname, arr in (outs or {}).items():
                if wname not in p.writes:
                    raise ValueError(
                        f"pass '{p.name}' writes resource '{wname}' without "
                        "declaring it with .write()")
                resources[wname] = arr
                if count is not None:
                    count(p, wname, arr)
        return resources

    def render(self, scene, view) -> dict[str, torch.Tensor]:
        """Run the recorded passes in order. `view` (a host RenderSettings) is
        uploaded once. Returns every resource of the frame; persistent ones
        are kept in `state` for the next frame. With sanitize, every floating
        output whose resource is not exempt is checked, its non-finite count
        made on the device, and the counts of the frame read with one copy."""
        self.prepare()
        if isinstance(view, RenderSettings):
            view = view.to(self.device)
        checks: dict[str, torch.Tensor] = {}

        def count(p, name, arr):
            desc = self.descs.get(name)
            if arr.is_floating_point() and (desc is None or desc.sanitize):
                checks[f"{p.name}/{name}"] = _nonfinite(arr)

        fell_back: set[str] = set()
        resources = self._run_passes(self.passes, dict(self.state), scene, view,
                                     count if self.sanitize else None, fell_back)
        self._last_good.update({p.name: (p.fn, p.takes_uniforms, self._generation)
                                for p in self.passes if p.name not in fell_back})
        self.state.update({n: resources[n] for n in self.persist if n in resources})
        if checks:
            self._report(checks)
        return resources

    def _report(self, checks: dict[str, torch.Tensor], frames: int = 1) -> None:
        """The nonzero counts of `checks` (device scalars), read with one copy,
        into last_sanitizer_report; logged unless their pass is suppressed."""
        counts = torch.stack(list(checks.values())).cpu().tolist() if checks else []
        self.last_sanitizer_report = {k: c for k, c in zip(checks, counts) if c > 0}
        for key, c in self.last_sanitizer_report.items():
            if key.split("/", 1)[0] not in self.suppress:
                log.error("sanitizer: %s produced %d non-finite values%s", key, c,
                          "" if frames == 1 else f" across the {frames}-frame loop")

    def _sanitized_writes(self, passes) -> list[str]:
        """The `render_loop` sanitizer's keys: each declared floating write
        (a resource declared and not exempt) as "pass/resource"."""
        keys = []
        for p in passes:
            for w in p.writes:
                d = self.descs.get(w)
                if d is not None and d.sanitize and d.dtype.is_floating_point:
                    keys.append(f"{p.name}/{w}")
        return keys

    # -- the device loop (the JAX package's graph.py:341-372, 484-690) -------

    def _split_prefix(self) -> tuple[list[RenderPass], list[RenderPass]]:
        """(the leading run of isolated passes, the passes after it)."""
        n = 0
        while n < len(self.passes) and self.passes[n].isolated:
            n += 1
        return self.passes[:n], self.passes[n:]

    def device_loop_unsupported_reason(self) -> str | None:
        """Why `render_loop` cannot run the current pass list as the host
        loop would (None: it can). The one rule behind render_loop's
        ValueError and Application.run_on_device's host loop. A row-sharded
        graph runs: its collectives are part of every frame's body."""
        prefix, main = self._split_prefix()
        if any(p.isolated for p in main):
            return ("isolated pass after a non-isolated pass: only a leading "
                    "isolated prefix is supported")
        if prefix and not main:
            return "every pass is isolated: the loop body would render nothing"
        frame_written = {w for p in self.passes for w in p.writes}
        for p in prefix:
            # The prefix runs for all N frames before the body: a prefix
            # pass reading persistent state that the frames update would see
            # its value from before the loop in every frame.
            bad = set(p.reads) & self.persist & frame_written
            if bad:
                return (f"isolated prefix pass '{p.name}' reads per-frame persistent "
                        f"state {sorted(bad)}: the prefix cannot chain it across frames")
        return None

    def capture_unsupported_reason(self) -> str | None:
        """Why `render_loop` cannot capture its body (the passes after the
        isolated prefix) into a CUDA graph: a row-sharded graph whose group
        is not NCCL's (a CUDA graph holds NCCL collectives, not gloo's,
        which move the tensors through the host); None where it can."""
        if self.band is not None:
            backend = torch.distributed.get_backend(self.band.group)
            if backend != "nccl":
                return (f"{backend} collectives cannot be captured (the graph is "
                        f"row-sharded over a {backend} group)")
        return None

    def render_loop(self, scene, view, n_frames: int, view_update=None, aux=None):
        """Render `n_frames` frames, the view of frame k derived on the
        device by `view_update(view, k, aux)` (k a () int32 tensor, `aux` a
        dict of host values uploaded once), with no readback between frames.
        Returns the last frame's `present_output` (None where the graph
        declares none).

        - A leading run of isolated passes runs first, for all N frames;
          what it writes that the other passes read (or that is persistent)
          is stacked on a leading frame axis, and frame k reads slice k.
        - Persistent resources that the other passes write are the carry:
          each frame reads the last one's. Other state (the environment
          maps) is read as it is. Afterwards `state` holds the last frame's
          values, and a persistent resource only the prefix writes holds its
          last frame's; `current_frame` grows by N.
        - On CUDA the body is captured once into a `torch.cuda.CUDAGraph`:
          the first call runs frame 1 eagerly on a side stream (loading and
          building every kernel), captures the body, and replays it for
          frames 2..N; a later call with the same key replays all N. The
          key is the passes, what their bodies close over (tensors by
          identity, since the capture holds their pointers, and kept alive
          with it; host values by value), the resource declarations, the
          state read as it is, the scene's tensors and `view_update`; not
          N, except through the stacked prefix writes, which hold N frames
          (so a graph with an isolated prefix captures anew for another
          N). A changed key captures anew, and so does toggling the
          profiler: a capture holds the passes' device spans only while it
          is enabled. A failed capture raises.
        - Eagerly, the same body N times: on CPU tensors, and on CUDA where
          `capture_unsupported_reason` gives a reason. `last_loop_form`
          says which.
        - The passes' uniforms are read from the graph's device buffers,
          which keep their identity across rebuilds of the same structure:
          a replay reads the values of the last build.
        - On a row-sharded graph the body runs this rank's band, its
          collectives in every frame (in the captured graph too, over
          NCCL); every rank of the group must call it with the same N.
        - With sanitize, the non-finite values of each declared floating
          write of the prefix and the body (`_sanitized_writes`) are summed
          over the N frames into device counters that the body adds to (in
          the captured form too), zeroed before frame 1 and read with one
          copy after the call into `last_sanitizer_report`. A pass that
          fails here raises: the hot-reload fallback is `render`'s alone.

        Raises ValueError where `device_loop_unsupported_reason` gives a
        reason. The JAX loop's frame checksum has no counterpart (eager
        torch elides no frame)."""
        reason = self.device_loop_unsupported_reason()
        if reason is not None:
            raise ValueError(f"render_loop: {reason}")
        if n_frames < 1:
            raise ValueError(f"render_loop: n_frames must be at least 1, got {n_frames}")
        self.prepare()
        prefix, main = self._split_prefix()
        written = {w for p in main for w in p.writes}
        main_reads = {r for p in main for r in p.reads}
        prefix_writes = dict.fromkeys(w for p in prefix for w in p.writes)
        stacked_names = [n for n in prefix_writes if n in main_reads or n in self.persist]
        carry_names = sorted(n for n in self.persist if n in self.state and n in written)
        inv = {n: t for n, t in self.state.items() if n not in carry_names}
        fresh_view = view.to(self.device)
        aux = {k: to_tensor(v, self.device) for k, v in (aux or {}).items()}
        stacked, prefix_checks = {}, {}
        if self.sanitize:
            prefix_checks = {k: torch.zeros((), dtype=torch.int64, device=self.device)
                             for k in self._sanitized_writes(prefix)}
        if prefix:
            stacked = self._run_prefix(prefix, inv, scene, fresh_view, n_frames,
                                       view_update, aux, stacked_names, prefix_checks)
        present = self.descs.get("present_output")
        san_keys = self._sanitized_writes(main) if self.sanitize else []

        def new_loop(key) -> _Loop:
            return _Loop(
                view=RenderSettings(**{f: t.clone() for f, t in vars(fresh_view).items()}),
                aux=aux, k=torch.zeros((), dtype=torch.int32, device=self.device),
                carry={n: self.state[n].clone() for n in carry_names}, inv=inv,
                stacked=stacked,
                present=None if present is None else present.allocate(device=self.device),
                passes=main, scene=scene, view_update=view_update, key=key,
                san={k: torch.zeros((), dtype=torch.int64, device=self.device)
                     for k in san_keys})

        why = (f"no CUDA graphs on {self.device.type}" if self.device.type != "cuda"
               else self.capture_unsupported_reason())
        if why is not None:
            loop = new_loop(None)
            for _ in range(n_frames):
                self._loop_body(loop)
            self.last_loop_form = f"eager: {why}"
        else:
            layout = lambda d: [(n, str(t.dtype), tuple(t.shape)) for n, t in d.items()]
            key = _value_key((
                [(p.name, p.fn, p.reads, p.writes, dict(p.uniforms)) for p in main],
                sorted((d.name, d.shape, str(d.dtype), d.clear, d.sanitize)
                       for d in self.descs.values()),
                san_keys, carry_names, inv, scene, view_update, layout(vars(fresh_view)),
                layout(aux), layout(stacked), self.band, PROFILER.enabled))
            loop = self._loop
            if loop is None or loop.key != key:
                loop = self._loop = None  # frees the last capture's memory first
                loop = new_loop(key)
                self._capture(loop)
                replays = n_frames - 1
                self._loop = loop
            else:
                loop.reload(fresh_view, aux, self.state, stacked)
                replays = n_frames
            for _ in range(replays):
                loop.graph.replay()
            if replays:  # the last replay's pass spans; the capture ran none
                PROFILER.queue(loop.spans)
            self.last_loop_form = "captured"
        self.state.update({n: t.clone() for n, t in loop.carry.items()})
        for n in stacked_names:
            if n in self.persist and n not in written:
                self.state[n] = stacked[n][-1]
        self.current_frame += n_frames
        if self.sanitize:
            self._report({**prefix_checks, **loop.san}, n_frames)
        return None if loop.present is None else loop.present.clone()

    def _run_prefix(self, prefix, inv, scene, view, n_frames, view_update, aux,
                    names, checks: dict) -> dict[str, torch.Tensor]:
        """The isolated prefix for frames 0..N-1 (the JAX package's
        `lax.map`): each written resource in `names`, stacked over frames;
        the non-finite counts of the writes keyed in `checks` added to it."""
        frames = []
        for i in range(n_frames):
            k = torch.full((), i, dtype=torch.int32, device=self.device)
            view_k = view if view_update is None else view_update(view, k, aux)
            resources = self._run_passes(prefix, dict(inv), scene, view_k,
                                         _counter(checks))
            frames.append({n: resources[n] if n in resources
                           else self.descs[n].allocate(device=self.device) for n in names})
        return {n: torch.stack([f[n] for f in frames]) for n in names}

    def _loop_body(self, loop: "_Loop") -> None:
        """One frame of `loop`, entirely in its tensors: frame k's view from
        the base view, the passes over the carry, the invariant state and
        slice k of the stacks; the carry and present_output written back in
        place; k + 1."""
        view = (loop.view if loop.view_update is None
                else loop.view_update(loop.view, loop.k, loop.aux))
        resources = dict(loop.inv)
        resources.update(loop.carry)
        index = loop.k.reshape(1)
        for name, arr in loop.stacked.items():
            resources[name] = arr.index_select(0, index)[0]
        self._run_passes(loop.passes, resources, loop.scene, view, _counter(loop.san),
                         spans=loop.spans)
        for name, t in loop.carry.items():
            t.copy_(resources[name])
        if loop.present is not None and "present_output" in resources:
            loop.present.copy_(resources["present_output"])
        loop.k.add_(1)

    def _capture(self, loop: "_Loop") -> None:
        """Frame 1 of `loop` eagerly on a side stream (every kernel library
        is loaded and every lazily made constant exists before capture, as
        torch's capture rules ask), then the body captured into
        `loop.graph`; capture runs nothing, so the loop stands after frame
        1."""
        current = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            self._loop_body(loop)
        current.wait_stream(side)
        loop.graph = torch.cuda.CUDAGraph()
        # A row-sharded body holds NCCL collectives; frame 1 above has set up
        # the communicator. Thread-local capture leaves the process group's
        # watchdog thread free to query its events while this thread
        # captures (in the default global mode those queries break it).
        mode = "global" if self.band is None else "thread_local"
        with torch.cuda.graph(loop.graph, stream=side, capture_error_mode=mode):
            self._loop_body(loop)
        self.captures += 1


@dataclasses.dataclass
class _Loop:
    """The tensors one render_loop body reads and writes in place: on CUDA,
    the static inputs and outputs of its captured graph, which holds their
    pointers (and, through the passes' closures, the tables the kernels
    read)."""

    view: RenderSettings  # the base view; frame k's is view_update(view, k, aux)
    aux: dict
    k: torch.Tensor  # () int32, the frame index
    carry: dict
    inv: dict
    stacked: dict
    present: torch.Tensor | None
    passes: list
    scene: object
    view_update: Callable | None
    key: object
    san: dict  # "pass/resource" -> () int64 non-finite count, summed over the frames
    graph: object = None
    # The captured body's pass spans: (name, start, end) external event
    # pairs that every replay records again.
    spans: list = dataclasses.field(default_factory=list)

    def reload(self, view: RenderSettings, aux: dict, state: dict, stacked: dict) -> None:
        """A new call's inputs copied into the captured tensors; k = 0 and
        the sanitizer's counts 0."""
        for name, t in vars(self.view).items():
            t.copy_(getattr(view, name))
        for name, t in self.aux.items():
            t.copy_(aux[name])
        for name, t in self.carry.items():
            t.copy_(state[name])
        for name, t in self.stacked.items():
            t.copy_(stacked[name])
        for t in self.san.values():
            t.zero_()
        self.k.zero_()


def _nonfinite(t: torch.Tensor) -> torch.Tensor:
    """The () int64 count of t's NaN and infinite values, on t's device."""
    return torch.isfinite(t).logical_not().sum()


def _counter(checks: dict):
    """A `_run_passes` count that adds the non-finite values of each output
    keyed "pass/resource" in `checks` to its () int64 tensor, in place (so
    that a captured body adds to the same tensor on every replay)."""
    if not checks:
        return None

    def count(p, name, arr):
        key = f"{p.name}/{name}"
        if key in checks:
            checks[key].add_(_nonfinite(arr))

    return count


def _value_key(x, _path=()):
    """A comparable key of what `x` computes with: numbers, strings, enums,
    configs and host tensors by value; device tensors and numpy arrays by
    identity (a capture holds their pointers, and keeps them alive); a
    function by its code and what it closes over, in turn."""
    if x is None or isinstance(x, (bool, int, float, str, bytes, enum.Enum, torch.dtype,
                                   torch.device)):
        return x
    if isinstance(x, np.generic):
        return ("np", x.dtype.str, x.item())
    if id(x) in _path:
        return ("cycle", id(x))
    path = _path + (id(x),)
    if isinstance(x, torch.Tensor):
        if x.device.type == "cpu":
            # Host tables travel in the launches' parameters (the seed table).
            return ("host", str(x.dtype), tuple(x.shape), x.numpy().tobytes())
        return ("tensor", id(x), x.data_ptr(), str(x.dtype), tuple(x.shape))
    if isinstance(x, (tuple, list)):
        return (type(x).__name__, tuple(_value_key(v, path) for v in x))
    if isinstance(x, dict):
        return ("dict", tuple((k, _value_key(v, path)) for k, v in x.items()))
    if isinstance(x, functools.partial):
        return ("partial", _value_key((x.func, x.args, x.keywords), path))
    if inspect.isfunction(x):
        cells = []
        for cell in x.__closure__ or ():
            try:
                cells.append(_value_key(cell.cell_contents, path))
            except ValueError:  # an empty cell
                cells.append(("empty",))
        return ("fn", x.__code__, _value_key(x.__defaults__, path), tuple(cells))
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__qualname__,
                tuple(_value_key(getattr(x, f.name), path) for f in dataclasses.fields(x)))
    return ("object", type(x).__qualname__, id(x))


def _takes_uniforms(fn) -> bool:
    """Whether a pass body takes the uniforms as its fourth argument (the
    JAX package's form) rather than only (resources, scene, view)."""
    try:
        params = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):  # no signature to read: the JAX form
        return True
    positional = [p for p in params if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    return len(positional) >= 4 or any(p.kind == p.VAR_POSITIONAL for p in params)


def _call(fn, takes_uniforms: bool, resources, scene, view, uniforms):
    return fn(resources, scene, view, uniforms) if takes_uniforms else fn(resources, scene,
                                                                          view)


# Host dtypes that the JAX package narrows (64-bit types are off there).
_NARROW = {np.dtype(np.float64): np.float32, np.dtype(np.int64): np.int32,
           np.dtype(np.uint64): np.uint32}
_ARENA_BYTES = 4096  # one arena holds a frame's uniforms many times over
_ALIGN = 16


class _Arena:
    """A block of uniform slots: the values in host memory, the device
    buffer that holds them, and (on CUDA) a pinned staging buffer that
    carries them over in one non-blocking copy. The staging buffer is
    refilled only after its last copy has finished (its event)."""

    def __init__(self, device: torch.device, nbytes: int):
        self.host = np.zeros(nbytes, np.uint8)
        self.device_buf = torch.zeros(nbytes, dtype=torch.uint8, device=device)
        self.used = 0
        self.dirty = False
        self.staging = (torch.empty(nbytes, dtype=torch.uint8).pin_memory()
                        if device.type == "cuda" else None)
        self.event = None  # recorded after the last copy from `staging`

    def take(self, nbytes: int) -> int | None:
        """The offset of `nbytes` new bytes in this arena, or None if full."""
        start = -(-self.used // _ALIGN) * _ALIGN
        if start + nbytes > self.host.size:
            return None
        self.used = start + nbytes
        return start

    def upload(self) -> None:
        n = self.used
        if self.staging is None:
            self.device_buf[:n].copy_(torch.from_numpy(self.host[:n]))
        else:
            if self.event is not None:
                self.event.synchronize()
            self.staging.numpy()[:n] = self.host[:n]
            self.device_buf[:n].copy_(self.staging[:n], non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        self.dirty = False


class _UniformStore:
    """The graph's uniform buffers: one device tensor per (pass, name,
    shape, dtype), a view of an arena's device buffer, kept for the graph's
    life, so that a rebuild with new values hands the passes the same
    tensors (a captured loop holds their pointers). `write` stages a value
    in host memory; `upload` copies what changed, one copy per arena (one a
    frame: a frame's uniforms take a few hundred bytes)."""

    def __init__(self, device: torch.device):
        self.device = device
        self.arenas: list[_Arena] = []
        self.slots: dict[tuple, tuple[_Arena, int, torch.Tensor]] = {}

    def write(self, pass_name: str, name: str, value) -> torch.Tensor:
        """The device tensor of (pass, name, value's shape and dtype), the
        value staged for the next `upload` (a tensor is read to the host
        first)."""
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        value = np.asarray(value)
        value = np.array(value, _NARROW.get(value.dtype, value.dtype), order="C")
        dtype = torch.from_numpy(value.reshape(-1)[:0]).dtype
        key = (pass_name, name, value.shape, dtype)
        if key not in self.slots:
            arena = self.arenas[-1] if self.arenas else None
            offset = None if arena is None else arena.take(max(value.nbytes, 1))
            if offset is None:
                arena = _Arena(self.device, max(_ARENA_BYTES, value.nbytes + _ALIGN))
                self.arenas.append(arena)
                offset = arena.take(max(value.nbytes, 1))
            tensor = arena.device_buf[offset:offset + value.nbytes].view(dtype).view(value.shape)
            self.slots[key] = (arena, offset, tensor)
        arena, offset, tensor = self.slots[key]
        arena.host[offset:offset + value.nbytes] = value.reshape(-1).view(np.uint8)
        arena.dirty = True
        return tensor

    def upload(self) -> None:
        for arena in self.arenas:
            if arena.dirty:
                arena.upload()
