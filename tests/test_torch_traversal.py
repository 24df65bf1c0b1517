"""BVH traversal of the PyTorch port against the JAX package.

On the CPU the port's `traverse` takes its plain version (the stackless walk
over `node_packed`); it is held against the JAX package's plain walk
(`ops/bvh.py::traverse`), its packet walk, and its TPU kernel K1
(`traverse_packet_pallas` with row cursors, run in Pallas interpret mode as
tests/test_pallas_traversal.py runs it). Tolerances: t to rtol 1e-6 on hits;
prim equal except where the two t agree to 1e-6 (an exact tie between
triangles); any-hit flags equal. Kernel K1 itself is tested on the card by
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.scene import Material, MaterialType, ModelLoader
from rust_renderer_tpu.utils import math3d

from rust_renderer_tpu_torch.convert import bvh_from_numpy, packed_scene_from_numpy
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.ops import traversal

torch.set_num_threads(1)


def _soup(n=150, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e[:, 0], base + e[:, 1]], 1).reshape(-1, 3)
    return pos, np.arange(n * 3, dtype=np.int32).reshape(-1, 3)


def _rays(n=1024, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::61] = 0.0  # retired lanes: the degenerate-ray guard
    t_max = rng.uniform(2.0, 20.0, n).astype(np.float32)
    return o, d, t_max


def _port_bvh(jax_tree):
    return bvh_from_numpy(
        {k: np.asarray(getattr(jax_tree, k))
         for k in ("node_packed", "leaf_packed", "wnode_packed", "max_depth",
                   "wide_depth")}, "cpu")


def _assert_same_hits(got, want, any_hit=False):
    t1, p1 = (np.asarray(x) for x in got[:2])
    t2, p2 = (np.asarray(x) for x in want[:2])
    np.testing.assert_array_equal(p1 >= 0, p2 >= 0)
    if any_hit:
        return
    hit = p2 >= 0
    np.testing.assert_allclose(t1[hit], t2[hit], rtol=1e-6)
    tie = np.isclose(t1, t2, rtol=1e-6, atol=0)
    assert np.all((p1 == p2) | tie)
    same = hit & (p1 == p2)
    for a, b in zip(got[2:], want[2:]):
        np.testing.assert_allclose(np.asarray(a)[same], np.asarray(b)[same],
                                   rtol=1e-5, atol=1e-6)


def _port_traverse(tree, o, d, t_max, any_hit):
    return [x.numpy() for x in traversal.traverse(
        tree, torch.tensor(o), torch.tensor(d), 1e-3, torch.tensor(t_max),
        any_hit=any_hit)]


@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_plain_matches_jax_walks(seed, any_hit):
    pos, idx = _soup(seed=seed)
    jax_tree = jax_bvh.build_bvh(pos, idx, leaf_size=12)
    o, d, t_max = _rays(seed=seed + 1)
    got = _port_traverse(_port_bvh(jax_tree), o, d, t_max, any_hit)
    assert (got[1] >= 0).sum() > 20
    for walk in (jax_bvh.traverse, jax_bvh.traverse_packet):
        want = walk(jax_tree, jnp.asarray(o), jnp.asarray(d), 1e-3,
                    jnp.asarray(t_max), any_hit=any_hit)
        _assert_same_hits(got, want, any_hit)


def _pallas_k1(tree, o, d, t_max, any_hit):
    """The JAX package's K1 (row-cursor kernel, as make_closest_hit and
    make_any_hit configure it) in Pallas interpret mode."""
    from jax.experimental import pallas as pl
    from rust_renderer_tpu.ops.pallas import traversal as ptrav

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    ptrav.pl.pallas_call = patched
    try:
        return ptrav.traverse_packet_pallas(
            tree, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max),
            any_hit=any_hit, dual=True, steady_drain=3, drain_first=any_hit,
            row_cursors=8, row_expand=2, skip_drain=True, skip_expand=any_hit)
    finally:
        ptrav.pl.pallas_call = orig


@pytest.mark.parametrize("any_hit", [False, True])
def test_plain_matches_jax_pallas_k1(any_hit):
    pos, idx = _soup(seed=5)
    jax_tree = jax_bvh.build_bvh(pos, idx, leaf_size=12)
    o, d, t_max = _rays(seed=6)
    got = _port_traverse(_port_bvh(jax_tree), o, d, t_max, any_hit)
    _assert_same_hits(got, _pallas_k1(jax_tree, o, d, t_max, any_hit), any_hit)


def _sphere_scene():
    """Boxes + analytic spheres, packed by the JAX package."""
    r = JaxRenderer()
    for i, x in enumerate((-2.0, 0.0, 2.0)):
        r.add_model(ModelLoader.load_cube(),
                    math3d.translation([x, 0.0, -4.0 - i]) @ math3d.scale(1.2))
    r.add_model(ModelLoader.load_sphere(stacks=8, slices=12), math3d.translation([0, 2, -6]))
    r.add_sphere([1.0, -1.0, -3.0], 0.7, material=Material())
    r.add_sphere([-1.5, 1.5, -5.0], 0.9,
                 material=Material(material_type=MaterialType.METAL))
    scene = r.pack()
    return scene, {k: np.asarray(getattr(scene, k)) for k in scene.__dataclass_fields__}


def test_hit_queries_merge_spheres():
    jax_scene, fields = _sphere_scene()
    scene = packed_scene_from_numpy(fields, "cpu")
    jax_tree = jax_bvh.build_bvh(fields["positions"], fields["indices"], leaf_size=12)
    tree = torch_bvh.build_bvh(fields["positions"], fields["indices"])
    rng = np.random.default_rng(9)
    o = np.zeros((700, 3), np.float32) + rng.uniform(-0.3, 0.3, (700, 3)).astype(np.float32)
    d = np.stack([rng.uniform(-0.7, 0.7, 700), rng.uniform(-0.7, 0.7, 700),
                  -np.ones(700)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t_max = rng.uniform(3.0, 12.0, 700).astype(np.float32)

    want = jax_bvh.make_closest_hit(jax_tree, packet=False)(jax_scene, o, d)
    got = torch_bvh.make_closest_hit(tree)(scene, torch.tensor(o), torch.tensor(d))
    kind = got.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(want.kind))
    assert set(np.unique(kind)) == {0, 1, 2}
    tri = kind == 1

    def triangles_only(h):
        t, prim, u, v = (np.asarray(x) for x in (h.t, h.prim, h.u, h.v))
        return [t, np.where(tri, prim, -1), u, v]

    _assert_same_hits(triangles_only(got), triangles_only(want))
    # Sphere roots come from half_b^2 - a*c, which cancels: float32 rounding
    # differences between the frameworks grow there to ~1e-5 relative.
    sph = kind == 2
    np.testing.assert_array_equal(got.prim.numpy()[sph], np.asarray(want.prim)[sph])
    np.testing.assert_allclose(got.t.numpy()[sph], np.asarray(want.t)[sph], rtol=1e-4)

    want = jax_bvh.make_any_hit(jax_tree, packet=False)(jax_scene, o, d, 1e-3, t_max)
    got = torch_bvh.make_any_hit(tree)(scene, torch.tensor(o), torch.tensor(d), 1e-3,
                                       torch.tensor(t_max))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0 < got.numpy().mean() < 1


def test_bruteforce_matches_jax_and_bvh_query():
    from rust_renderer_tpu.ops import intersect as jax_intersect
    from rust_renderer_tpu_torch.ops import intersect as torch_intersect

    jax_scene, fields = _sphere_scene()
    scene = packed_scene_from_numpy(fields, "cpu")
    rng = np.random.default_rng(10)
    o = rng.uniform(-0.3, 0.3, (300, 3)).astype(np.float32)
    d = np.stack([rng.uniform(-0.7, 0.7, 300), rng.uniform(-0.7, 0.7, 300),
                  -np.ones(300)], -1).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    got = torch_intersect.closest_hit_bruteforce(scene, torch.tensor(o), torch.tensor(d))
    want = jax_intersect.closest_hit_bruteforce(jax_scene, o, d)
    kind = got.kind.numpy()
    np.testing.assert_array_equal(kind, np.asarray(want.kind))
    tri = kind == 1
    np.testing.assert_array_equal(got.prim.numpy()[tri], np.asarray(want.prim)[tri])
    np.testing.assert_allclose(got.t.numpy()[tri], np.asarray(want.t)[tri], rtol=1e-6)
    # The BVH query finds the same nearest surfaces.
    tree = torch_bvh.build_bvh(fields["positions"], fields["indices"])
    bvh_hit = torch_bvh.make_closest_hit(tree)(scene, torch.tensor(o), torch.tensor(d))
    np.testing.assert_array_equal(bvh_hit.kind.numpy(), kind)
    np.testing.assert_allclose(bvh_hit.t.numpy(), got.t.numpy(), rtol=1e-6)
