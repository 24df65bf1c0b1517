"""The port's deferred composite on CPU tensors
(``ops/deferred.py::deferred_composite``, the plain body that the card's
kernel is held to) against the JAX package's deferred pass body
(``rust_renderer_tpu/renderers/passes.py::setup_deferred_pass``'s render
function), on the same small image of random surfaces with rows planted in
every shadow cascade, under every combination of the pass's toggles with 0,
3 and 10 lights, and on bands of rows.

Tolerance, and why: the composite is elementwise float32 in the JAX pass's
order, so every channel agrees to 1e-4 x max(1, |JAX|), the pbr and ibl
modules' tolerance in tests/test_torch_raster_ops.py (powf, exp and the GGX
terms may differ in the last ulp between the two libraries, carried through
the lights' sum; these inputs read at most 1.2e-5, and no PCF comparison
flips on them).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu.graph import Graph as JaxGraph
from rust_renderer_tpu.renderers.passes import setup_deferred_pass
from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings

from rust_renderer_tpu_torch.ops import deferred

from test_torch_deferred_kernel import (
    COMBOS, LIGHT_COUNTS, _call, _cpu_inputs, _view, cascades_reached)

RTOL = 1e-4


@functools.lru_cache(maxsize=None)
def _jax_pass(height: int, width: int, n_levels: int):
    """The JAX deferred pass's body for (height, width) planes and n_levels
    specular levels, jitted: fn(resources, scene tables, view, uniforms)."""
    graph = JaxGraph()
    setup_deferred_pass(graph, types.SimpleNamespace(cubemap_mips=n_levels), width, height,
                        np.eye(4, dtype=np.float32)[None], np.ones(1, np.float32))
    (deferred_pass,) = graph.passes
    return jax.jit(lambda res, tables, view, u: deferred_pass.fn(
        res, types.SimpleNamespace(**tables), view, u)["deferred_output"])


def _jax_deferred(scene, view, p):
    """The JAX deferred pass's body on the planes `p` (torch tensors)."""
    j = lambda x: jnp.asarray(x.numpy())
    res = {"gbuffer_position": j(p["position"]), "gbuffer_normal": j(p["normal"]),
           "gbuffer_albedo": j(p["albedo"]), "gbuffer_pbr": j(p["pbr"]),
           "shadow_map": j(p["shadow_map"]), "rt_shadows": j(p["rt_shadows"]),
           "rt_reflections": j(p["rt_reflections"]), "ssao_output": j(p["ssao"]),
           "irradiance_map": j(p["irradiance_map"]), "brdf_lut": j(p["brdf_lut"]),
           **{f"specular_map_mip{m}": j(level) for m, level in enumerate(p["specular_map"])}}
    jview = JaxRenderSettings(**{f.name: j(getattr(view, f.name))
                                 for f in dataclasses.fields(JaxRenderSettings)})
    body = _jax_pass(p["position"].shape[0], p["position"].shape[1], len(p["specular_map"]))
    out = body(res, {k: j(v) for k, v in vars(scene).items()}, jview,
               {"cascade_vp": j(p["cascade_vp"]), "cascade_splits": j(p["cascade_splits"])})
    return torch.tensor(np.asarray(out))


def _assert_matches_jax(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.shape == want.shape and got.dtype == want.dtype == torch.float32
    assert not bool(torch.isnan(got).any()) and not bool(torch.isnan(want).any())
    assert bool((got[..., 3] == 1.0).all())
    excess = (got - want).abs() - RTOL * torch.clamp_min(want.abs(), 1.0)
    assert float(excess.max()) <= 0.0, f"worst excess {float(excess.max()):.3e}"


@pytest.mark.parametrize("combo", COMBOS, ids=lambda c: "".join(map(str, c)))
def test_cpu_composite_matches_the_jax_deferred_pass(combo):
    camera, scene, p = _cpu_inputs()
    for num_lights in LIGHT_COUNTS:
        view = _view(camera, num_lights, combo, "cpu")
        _assert_matches_jax(_call(deferred.deferred_composite, scene, view, p),
                            _jax_deferred(scene, view, p))


@pytest.mark.parametrize("combo", [(1, 1, 1, 1, 1), (1, 0, 1, 0, 1), (0, 1, 0, 1, 0)],
                         ids=lambda c: "".join(map(str, c)))
def test_cpu_composite_on_a_band_of_rows(combo):
    """A row band (a row-sharded graph's rows, here the planted cascade
    rows among them): the JAX pass on the same band."""
    camera, scene, p = _cpu_inputs()
    view = _view(camera, 10, combo, "cpu")
    image = ("position", "normal", "albedo", "pbr", "rt_reflections", "rt_shadows", "ssao")
    band = {k: (v[1:6] if k in image else v) for k, v in p.items()}
    assert cascades_reached(band, view) == {0, 1, 2, 3}
    got = _call(deferred.deferred_composite, scene, view, band)
    assert got.shape == (5, 20, 4)
    _assert_matches_jax(got, _jax_deferred(scene, view, band))
