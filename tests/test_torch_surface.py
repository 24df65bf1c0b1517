"""The port's public surface against the JAX package's, module by module.

For each module of ``rust_renderer_tpu`` that has a counterpart of the same
path in ``rust_renderer_tpu_torch``:
- every public name the JAX module defines at top level (functions,
  classes, constants; not what it imports) exists in the port, and every
  public method of such a class on the port's class;
- for each function and method in both, the JAX positional parameters are
  a prefix of the port's, and a port-only `device` parameter is
  keyword-only, so that a call in the JAX positional form means the same.

The exceptions are listed below with their reasons. They mirror ROADMAP.md
§1 "Not ported" (TPU-layout helpers, the XLA walks, the JAX-only modules)
and the torch.distributed group that stands where the JAX package takes a
mesh.
"""

import ast
import importlib
import inspect
import pkgutil

import pytest

import rust_renderer_tpu
import rust_renderer_tpu_torch

# JAX modules with no port counterpart.
NO_PORT_MODULE = {
    "rust_renderer_tpu.ops.pallas": "the Pallas TPU kernels; the port's are csrc/*.cu",
    "rust_renderer_tpu.ops.pallas.traversal": "the Pallas TPU kernels; csrc/traverse_*.cu",
    "rust_renderer_tpu.ops.bvh_opt": "BVH reinsertion is not ported (12-slot SAH trees only)",
    "rust_renderer_tpu.utils.compile_cache": "the JAX compilation cache",
}

# Public names of a JAX module that the port does not define.
NOT_PORTED = {
    ("rust_renderer_tpu.settings", "PackedView"): "TPU layout: the view packed into one "
                                                  "f32 buffer for one host transfer",
    ("rust_renderer_tpu.settings", "pack_view"): "TPU layout (PackedView)",
    ("rust_renderer_tpu.settings", "unpack_view"): "TPU layout (PackedView)",
    ("rust_renderer_tpu.ops.cubemap", "pack_cubemap"): "TPU layout of the cubemap",
    ("rust_renderer_tpu.ops.texture", "pack_textures_quad"): "TPU layout of the textures",
    ("rust_renderer_tpu.ops.gather", "bitcast_f32"): "TPU-layout helper; nothing on a port "
                                                     "path calls it",
    ("rust_renderer_tpu.ops.gather", "bitcast_i32"): "TPU-layout helper",
    ("rust_renderer_tpu.ops.raster_binned", "CAP"): "the Pallas kernel's VMEM chunk rows",
    ("rust_renderer_tpu.ops.bvh", "traverse"): "the XLA binary stackless walk; "
                                               "ops/traversal.py::traverse replaces it",
    ("rust_renderer_tpu.ops.bvh", "traverse_packet"): "an XLA walk (ops/traversal.py)",
    ("rust_renderer_tpu.ops.bvh", "traverse_packet_sorted"): "an XLA walk (ops/traversal.py)",
    ("rust_renderer_tpu.parallel.tiles", "make_tile_mesh"): "no mesh in torch: "
                                                            "make_tile_group replaces it",
    **{("rust_renderer_tpu.ops.bvh", f"BVH.{field}"): "the XLA walks' unpacked tables; the "
       "port's walks and kernels read node_packed / leaf_packed / wnode_packed"
       for field in ("node_min", "node_max", "node_miss", "node_leaf", "leaf_tris",
                     "leaf_v0", "leaf_e1", "leaf_e2")},
}

# JAX positional parameters that the port names otherwise: the process group
# stands where the JAX package takes its mesh (or, inside shard_map, the
# mesh axis that its collectives name).
RENAMED = {"mesh": "group"}
RENAMED_IN = {("rust_renderer_tpu.parallel.flagship", "flagship_step"): {"axis": "group"}}

# JAX parameters the port leaves out, by function.
NOT_PORTED_PARAMS = {
    ("rust_renderer_tpu.graph", "RenderPass.__init__"): {
        "fn_key": "the JAX jit cache's key; the port keys a captured loop by the "
                  "pass function's value (graph.py::_value_key)"},
}


def _modules(package) -> list[str]:
    """The package's Python modules (not the compiled libraries beside them)."""
    names = [package.__name__]
    for info in pkgutil.walk_packages(package.__path__, package.__name__ + "."):
        spec = importlib.util.find_spec(info.name)
        if spec.origin and spec.origin.endswith(".py"):
            names.append(info.name)
    return names


def _defined(module) -> list[str]:
    """The public names a module's source defines at top level."""
    with open(module.__file__) as f:
        tree = ast.parse(f.read())
    names = []
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names += [t.id for t in node.targets if isinstance(t, ast.Name)]
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.append(node.target.id)
    return [n for n in dict.fromkeys(names) if not n.startswith("_")]


JAX_MODULES = _modules(rust_renderer_tpu)


def _port_name(name: str) -> str:
    return name.replace("rust_renderer_tpu", "rust_renderer_tpu_torch", 1)


def _has_port(name: str) -> bool:
    try:
        return importlib.util.find_spec(_port_name(name)) is not None
    except ModuleNotFoundError:  # its parent package is not in the port either
        return False


def _pairs(jax_mod: str):
    """(qualified name, JAX function, port function) of every function and
    method defined in both modules."""
    jm, tm = importlib.import_module(jax_mod), importlib.import_module(_port_name(jax_mod))
    for name in _defined(jm):
        a, b = getattr(jm, name), getattr(tm, name, None)
        if inspect.isfunction(a) and inspect.isfunction(b):
            yield name, a, b
        if inspect.isclass(a) and inspect.isclass(b):
            for attr, value in vars(a).items():
                if (attr.startswith("_") and attr != "__init__") or isinstance(value, property):
                    continue
                fa = getattr(a, attr)
                fb = getattr(b, attr, None)
                if inspect.isfunction(fa) and inspect.isfunction(fb):
                    yield f"{name}.{attr}", fa, fb


def _positional(fn) -> list[str]:
    return [p.name for p in inspect.signature(fn).parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def test_every_jax_module_has_a_port_counterpart():
    missing = []
    for name in JAX_MODULES:
        if name in NO_PORT_MODULE:
            assert not _has_port(name), f"{name} is ported now: drop it from NO_PORT_MODULE"
        elif not _has_port(name):
            missing.append(name)
    assert missing == []


@pytest.mark.parametrize("jax_mod", [m for m in JAX_MODULES if m not in NO_PORT_MODULE])
def test_public_names_exist_in_the_port(jax_mod):
    jm, tm = importlib.import_module(jax_mod), importlib.import_module(_port_name(jax_mod))
    missing = []
    for name in _defined(jm):
        if (jax_mod, name) in NOT_PORTED:
            assert not hasattr(tm, name), f"{name} is ported now: drop it from NOT_PORTED"
            continue
        if not hasattr(tm, name):
            missing.append(name)
            continue
        a, b = getattr(jm, name), getattr(tm, name)
        if inspect.isclass(a):
            for attr in vars(a):
                if (jax_mod, f"{name}.{attr}") in NOT_PORTED:
                    assert not hasattr(b, attr), f"{name}.{attr} is ported now"
                elif not attr.startswith("_") and not hasattr(b, attr):
                    missing.append(f"{name}.{attr}")
    assert missing == []


@pytest.mark.parametrize("jax_mod", [m for m in JAX_MODULES if m not in NO_PORT_MODULE])
def test_jax_positional_parameters_lead_the_port_ones(jax_mod):
    wrong = []
    for qual, a, b in _pairs(jax_mod):
        renamed = {**RENAMED, **RENAMED_IN.get((jax_mod, qual), {})}
        dropped = NOT_PORTED_PARAMS.get((jax_mod, qual), {})
        want = [renamed.get(p, p) for p in _positional(a) if p not in dropped]
        got = _positional(b)
        if got[:len(want)] != want:
            wrong.append(f"{qual}: JAX {want}, port {got}")
        device = inspect.signature(b).parameters.get("device")
        if (device is not None and device.kind != device.KEYWORD_ONLY
                and "device" not in _positional(a)):
            wrong.append(f"{qual}: `device` is not keyword-only")
    assert wrong == []


def test_every_exception_is_in_the_roadmap():
    """Each exception above is listed in ROADMAP.md's "Not ported"."""
    import os

    with open(os.path.join(os.path.dirname(__file__), "..", "ROADMAP.md")) as f:
        text = f.read()
    section = text[text.index("**Not ported**"):]
    section = section[:section.index("\n### ")]
    names = ([n.rsplit(".", 1)[-1] for n in NO_PORT_MODULE]
             + [name.rsplit(".", 1)[-1] for _, name in NOT_PORTED]
             + [p for params in NOT_PORTED_PARAMS.values() for p in params]
             + list(RENAMED) + ["make_tile_group"])
    assert [n for n in names if n not in section] == []
