"""The traversal entry points' kernel options: the port against the JAX
package.

- The tables the kernels read (`wnode_meta`, `wnode_q32`, `wnode_meta32`,
  `q32_leaf_perm`, `q32_depth`) must equal the JAX package's bit for bit,
  on soups, the default scene and the Sponza-scale scene (12-slot leaves).
- The q32 boxes must be conservative: each dequantized box contains its f32
  box, in exact arithmetic (float64).
- `select_kernel` must name the kernel the JAX rule launches. The JAX choice
  is read without running it: each `_make_kernel_*` maker of
  `ops/pallas/traversal.py` is replaced by one that records its name and
  raises. Where the JAX rule tests a Mosaic capacity (RC_SCAP), the test
  sets it to the value at which the rule's wide-depth threshold equals the
  port's (K1's stack).
- On CPU tensors the port's `traverse` takes its plain walk under every
  option. It is held against the JAX kernel with the same options in Pallas
  interpret mode (as tests/test_pallas_traversal.py runs it): t to rtol 1e-6
  on hits, prim equal off exact ties, any-hit flags equal.
- A tree of wide depth above 14 (more than K1's stack holds): the port's
  walk matches the JAX plain walk and `select_kernel` names K2, whose
  stack bound (`level_stack_need`), like K3's, holds for a walk that hits
  every box.

The kernels themselves are held against the plain walk on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu import Camera as JaxCamera
from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu.models import create_scene as jax_create_scene
from rust_renderer_tpu.models.scenes import create_sponza_scale_scene as jax_sponza_scale
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.ops.pallas import traversal as ptrav

from rust_renderer_tpu_torch import Camera, Renderer
from rust_renderer_tpu_torch.convert import bvh_from_numpy
from rust_renderer_tpu_torch.models import create_scene, create_sponza_scale_scene
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.ops import traversal
from rust_renderer_tpu_torch.scene import ModelLoader
from test_torch_host import ensure_jax_native_sah

torch.set_num_threads(1)

Q32_FIELDS = ("wnode_meta", "wnode_q32", "wnode_meta32", "q32_leaf_perm")


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()


def _soup(n=60, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e[:, 0], base + e[:, 1]], 1).reshape(-1, 3)
    return pos, np.arange(n * 3, dtype=np.int32).reshape(-1, 3)


def _nested(levels=20, per=200, ratio=0.3, size=1e4, seed=0):
    """Triangles in nested shells, each `ratio` the size of the last: SAH
    splits off one shell per level, and the wide collapse, which expands the
    largest box first, keeps the rest of the nest as one child per wide
    node, so the wide tree is about one level per shell deep."""
    rng = np.random.default_rng(seed)
    tris = []
    for k in range(levels):
        s = size * ratio ** k
        c = np.stack([rng.uniform(s / 2, s, per), rng.uniform(0, s, per),
                      rng.uniform(0, s, per)], 1)
        e = rng.normal(0.0, s / 20, (per, 2, 3))
        tris.append(np.stack([c, c + e[:, 0], c + e[:, 1]], 1))
    pos = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    return pos, np.arange(len(pos), dtype=np.int32).reshape(-1, 3)


def _rays(n=1024, seed=1):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::61] = 0.0  # retired lanes: the degenerate-ray guard
    t_max = rng.uniform(2.0, 20.0, n).astype(np.float32)
    return o, d, t_max


def _aimed_rays(pos, n=1024, seed=1):
    """Rays that start 4-10 units off a random triangle of the soup and head
    back at it along its normal, with degenerate lanes and per-ray t_max;
    about a quarter of them hit. The port's plain walk and the JAX package's
    XLA arithmetic round differently: on rays that start near a triangle (t
    small against its edges) about one hit in a few thousand differs by
    1-3e-6 relative, past the rtol of 1e-6; from 4-10 units, t is large
    enough that none does on these soups."""
    rng = np.random.default_rng(seed)
    tris = pos.reshape(-1, 3, 3)[rng.integers(0, len(pos) // 3, n)]
    normal = np.cross(tris[:, 1] - tris[:, 0], tris[:, 2] - tris[:, 0])
    normal /= np.linalg.norm(normal, axis=-1, keepdims=True)
    normal *= rng.choice([-1.0, 1.0], (n, 1))
    o = (tris.mean(axis=1) + normal * rng.uniform(4.0, 10.0, (n, 1))).astype(np.float32)
    d = (-normal + rng.normal(0.0, 0.05, (n, 3))).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::61] = 0.0
    t_max = rng.uniform(3.0, 30.0, n).astype(np.float32)
    return o, d, t_max


def _port_tree(jax_tree):
    fields = ("node_packed", "leaf_packed", "wnode_packed", "max_depth", "wide_depth",
              "q32_depth") + Q32_FIELDS
    return bvh_from_numpy({k: getattr(jax_tree, k) for k in fields}, "cpu")


def _assert_tables_equal(jax_tree, port: dict):
    for name in ("node_packed", "leaf_packed", "wnode_packed") + Q32_FIELDS:
        want = np.asarray(getattr(jax_tree, name))
        got = np.asarray(port[name])
        assert got.shape == want.shape, name
        np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32),
                                      err_msg=name)
    for name in ("max_depth", "wide_depth", "q32_depth"):
        assert port[name] == getattr(jax_tree, name), name


# -- the tables -----------------------------------------------------------------


@pytest.mark.parametrize("n,seed", [(150, 0), (3000, 3)])
def test_q32_tables_match_jax_on_soup(n, seed, jax_sah):
    pos, idx = _soup(n, seed)
    _assert_tables_equal(jax_bvh.build_bvh(pos, idx, leaf_size=12),
                         torch_bvh.build_bvh_numpy(pos, idx))


def test_q32_tables_match_jax_on_default_scene(jax_sah):
    jr = JaxRenderer()
    jax_create_scene(jr, JaxCamera([0, 0, 0], [0, 0, -1]))
    jr.ensure_mc_material()
    tr = Renderer()
    create_scene(tr, Camera([0, 0, 0], [0, 0, -1]))
    tr.ensure_mc_material()
    jax_scene, port = jr.pack(), tr.pack_numpy()
    tables = torch_bvh.build_bvh_numpy(port["positions"], port["indices"])
    _assert_tables_equal(jax_bvh.build_bvh(np.asarray(jax_scene.positions),
                                           np.asarray(jax_scene.indices), leaf_size=12),
                         tables)
    assert tables["wnode_meta"].shape == (tables["wnode_packed"].shape[0] + 1, 3)


def test_sponza_scale_scene_packs_and_builds_like_jax(jax_sah):
    jr = JaxRenderer()
    jax_sponza_scale(jr, JaxCamera([0, 0, 0], [0, 0, -1]))
    jr.ensure_mc_material()
    tr = Renderer()
    create_sponza_scale_scene(tr, Camera([0, 0, 0], [0, 0, -1]))
    tr.ensure_mc_material()
    jax_scene, port = jr.pack(), tr.pack_numpy()
    for f in dataclasses.fields(jax_scene):
        want = np.asarray(getattr(jax_scene, f.name))
        assert port[f.name].dtype == want.dtype, f.name
        np.testing.assert_array_equal(port[f.name], want, err_msg=f.name)
    assert jax_scene.num_triangles >= 250_000
    tables = torch_bvh.build_bvh_numpy(port["positions"], port["indices"])
    _assert_tables_equal(jax_bvh.build_bvh(np.asarray(jax_scene.positions),
                                           np.asarray(jax_scene.indices), leaf_size=12),
                         tables)
    # K1 takes this tree: its stack bound fits.
    assert traversal.k1_stack_need(tables["wide_depth"]) <= traversal.K1_STACK_CAP


@pytest.mark.parametrize("n,seed", [(200, 81), (3000, 82)])
def test_q32_quantization_is_conservative(n, seed):
    """Every dequantized child box of the port's q32 table contains its f32
    box of the width-32 collapse, in exact arithmetic."""
    pos, idx = _soup(n, seed)
    tables = torch_bvh.build_bvh_numpy(pos, idx)
    # The width-32 collapse of the final tree, rebuilt from node_packed.
    node = tables["node_packed"]
    packed, _, meta32, _ = torch_bvh._collapse_wide(
        node[:, 0:3], node[:, 3:6], node[:, 6].view(np.int32),
        node[:, 7].view(np.int32), width=32)
    np.testing.assert_array_equal(meta32, tables["wnode_meta32"])
    q = tables["wnode_q32"].view(np.uint32)
    n_rows = q.shape[0]
    boxes = packed[:, :6 * 32].reshape(n_rows, 6, 32)
    refs = packed[:, 6 * 32:].view(np.int32)
    origin = q[:, 96:99].view(np.float32).reshape(n_rows, 3).astype(np.float64)
    scale = q[:, 99:102].view(np.float32).reshape(n_rows, 3).astype(np.float64)
    qlo = np.stack([q[:, 0:32] & 0xFFFF, q[:, 0:32] >> 16, q[:, 32:64] & 0xFFFF], 1)
    qhi = np.stack([q[:, 32:64] >> 16, q[:, 64:96] & 0xFFFF, q[:, 64:96] >> 16], 1)
    lo_dq = origin[:, :, None] + qlo.astype(np.float64) * scale[:, :, None]
    hi_dq = origin[:, :, None] + qhi.astype(np.float64) * scale[:, :, None]
    valid = np.broadcast_to((refs != torch_bvh.WIDE_EMPTY)[:, None, :], lo_dq.shape)
    assert valid.sum() > 0
    assert (lo_dq[valid] <= boxes[:, 0:3, :][valid]).all()
    assert (hi_dq[valid] >= boxes[:, 3:6, :][valid]).all()


# -- the kernel rule ------------------------------------------------------------


_MAKERS = {
    "_make_kernel_wide_row": lambda *a, **k: "k1",
    "_make_kernel_wide_row32": lambda *a, **k: "k1q",
    "_make_kernel_wide_sd": lambda *a, **k: "k2_sd",
    "_make_kernel_wide_sdd": lambda *a, **k: "k2_sdd",
    "_make_kernel": lambda *a, **k: "k3_binary",
    "_make_kernel_ordered": lambda *a, **k: "k3_binary_ordered",
    "_make_kernel_wide": lambda leaf_size, any_hit, ordered, **k:
        "k3_wide_ordered" if ordered else "k3_wide",
    "_make_kernel_wide_dual": lambda *a, **k: "k3_wide_dual",
}


class _Chosen(Exception):
    pass


def _jax_kernel(tree, monkeypatch, any_hit, rc_scap=None, **options) -> str:
    """The port's name of the kernel the JAX package's
    traverse_packet_pallas launches with `options`."""
    for name, port_name in _MAKERS.items():
        def record(*a, _name=port_name, **k):
            raise _Chosen(_name(*a, **k))

        monkeypatch.setattr(ptrav, name, record)
    if rc_scap is not None:
        monkeypatch.setattr(ptrav, "RC_SCAP", rc_scap)
    o, d, _ = _rays(n=5 * 1024, seed=2)
    with jax.disable_jit(), pytest.raises(_Chosen) as chosen:
        ptrav.traverse_packet_pallas(tree, jnp.asarray(o), jnp.asarray(d),
                                     any_hit=any_hit, **options)
    return str(chosen.value)


# (JAX options, any_hit, expected port kernel): the rows of the rule.
_RULE_ROWS = [
    # make_closest_hit / make_any_hit defaults
    (dict(row_cursors=8, steady_drain=3, dual=True), False, "k1"),
    (dict(row_cursors=8, steady_drain=3, dual=True, drain_first=True), True, "k1"),
    # row_cursors=0, steady_drain=3 through the hit queries
    (dict(row_cursors=0, steady_drain=3, dual=True), False, "k2_sdd"),
    (dict(row_cursors=0, steady_drain=3, dual=True, drain_first=True), True, "k2_sdd"),
    # traverse_packet_pallas(steady_drain > 0, dual=False)
    (dict(steady_drain=3), False, "k2_sd"),
    (dict(steady_drain=2), True, "k2_sd"),
    # row_cursors=0, steady_drain=0
    (dict(row_cursors=0, steady_drain=0), False, "k3_wide"),
    (dict(row_cursors=0, steady_drain=0, ordered=True), False, "k3_wide_ordered"),
    (dict(row_cursors=0, steady_drain=0, dual=True), True, "k3_wide_dual"),
    (dict(row_cursors=8, steady_drain=0, dual=True, ordered=True, wide=False), True,
     "k3_binary_ordered"),
    (dict(wide=False), False, "k3_binary"),
    (dict(wide=False, ordered=True), False, "k3_binary_ordered"),
    # q32 with row cursors
    (dict(row_cursors=8, steady_drain=3, dual=True, q32=True), False, "k1q"),
    (dict(row_cursors=8, steady_drain=3, dual=True, q32=True), True, "k1q"),
    (dict(row_cursors=8, steady_drain=3, q32=True, wide=False), False, "k3_binary"),
    # stats turn the row kernels off
    (dict(stats=True), False, "k3_wide"),
    (dict(stats=True, ordered=True), False, "k3_wide_ordered"),
    (dict(stats=True, dual=True), True, "k3_wide_dual"),
    (dict(stats=True, steady_drain=3, dual=True, row_cursors=8), False, "k2_sdd"),
    (dict(stats=True, steady_drain=3, row_cursors=8, q32=True), False, "k2_sd"),
]


def _port_options(options):
    keys = ("wide", "ordered", "dual", "steady_drain", "row_cursors", "q32", "stats")
    port = {k: options[k] for k in keys if k in options}
    # traverse_packet_pallas's defaults where the row leaves an option out.
    port.setdefault("steady_drain", 0)
    port.setdefault("row_cursors", 0)
    return port


@pytest.fixture(scope="module")
def soup_trees(jax_sah):
    pos, idx = _soup(150, 4)
    jax_tree = jax_bvh.build_bvh(pos, idx, leaf_size=12)
    return jax_tree, _port_tree(jax_tree)


@pytest.mark.parametrize("options,any_hit,want", _RULE_ROWS)
def test_select_kernel_follows_the_jax_rule(options, any_hit, want, soup_trees,
                                            monkeypatch):
    jax_tree, port_tree = soup_trees
    assert _jax_kernel(jax_tree, monkeypatch, any_hit, **options) == want
    assert traversal.select_kernel(port_tree, any_hit, **_port_options(options)) == want


def test_select_kernel_without_row_cursor_tables(soup_trees, monkeypatch):
    """A tree without wnode_meta (the MC dynamic tree's case) or without the
    q32 tables falls back as in the JAX package."""
    jax_tree, port_tree = soup_trees
    for drop, options, want in (
            (("wnode_meta",), dict(row_cursors=8, steady_drain=3, dual=True), "k2_sdd"),
            (("wnode_meta",), dict(row_cursors=8, steady_drain=0), "k3_wide"),
            (("wnode_q32",), dict(row_cursors=8, steady_drain=3, dual=True, q32=True),
             "k1"),
            (("wnode_meta", "wnode_meta32"),
             dict(row_cursors=8, steady_drain=3, q32=True), "k2_sd")):
        jax_cut = jax_tree._replace(**{k: None for k in drop})
        port_cut = port_tree._replace(**{k: None for k in drop})
        assert _jax_kernel(jax_cut, monkeypatch, False, **options) == want
        assert traversal.select_kernel(port_cut, False, **_port_options(options)) == want


@pytest.fixture(scope="module")
def deep_trees(jax_sah):
    pos, idx = _nested()
    jax_tree = jax_bvh.build_bvh(pos, idx, leaf_size=12)
    return pos, idx, jax_tree, _port_tree(jax_tree)


@pytest.mark.parametrize("any_hit", [False, True])
def test_deep_tree_goes_to_k2(deep_trees, monkeypatch, any_hit):
    """K1's stack holds trees of wide depth <= 14; deeper trees go to K2 by
    the JAX rule with RC_SCAP set to the same threshold, not to a refusal."""
    _, _, jax_tree, port_tree = deep_trees
    assert port_tree.wide_depth > 14
    assert traversal.k1_stack_need(port_tree.wide_depth) > traversal.K1_STACK_CAP
    assert traversal.k1_stack_need(14) <= traversal.K1_STACK_CAP
    options = dict(row_cursors=8, steady_drain=3, dual=True)
    # JAX's threshold row_expand * (wide_depth + 1) + 2 > RC_SCAP, with
    # row_expand 2, falls at wide depth 15 when RC_SCAP is 32.
    assert _jax_kernel(jax_tree, monkeypatch, any_hit, rc_scap=32, **options) == "k2_sdd"
    assert traversal.select_kernel(port_tree, any_hit, **options) == "k2_sdd"
    assert traversal.select_kernel(port_tree, any_hit) == "k2_sd"


def _peak_stack(wnode_packed, dual, leaves_on_stack):
    """The deepest stack of a wide walk whose every child box is hit, in
    the kernels' order: pop A (and B, for a dual walk), push B's children,
    then A's. K2 keeps leaf rows off the stack; K3 pushes them too."""
    refs = np.asarray(wnode_packed)[:, 6 * traversal.K1_WIDTH:].view(np.int32)
    stack, peak = [0], 1
    while stack:
        popped = [stack.pop()]
        if dual and stack:
            popped.append(stack.pop())
        for ref in reversed(popped):
            if ref >= 0:
                stack += [int(c) for c in refs[ref] if c != torch_bvh.WIDE_EMPTY
                          and (c >= 0 or leaves_on_stack)]
        peak = max(peak, len(stack))
    return peak


@pytest.mark.parametrize("dual", [False, True])
@pytest.mark.parametrize("mesh", ["soup", "nested"])
def test_stack_bounds_hold_when_every_box_is_hit(mesh, dual):
    """K2 and K3 size their stacks by `level_stack_need`; a walk that hits
    every box, the widest there is, stays inside it."""
    pos, idx = _soup(3000, 6) if mesh == "soup" else _nested()
    tables = torch_bvh.build_bvh_numpy(pos, idx)
    depth = tables["wide_depth"]
    assert _peak_stack(tables["wnode_packed"], dual, False) <= \
        traversal.level_stack_need(depth, dual)
    assert _peak_stack(tables["wnode_packed"], dual, True) <= \
        traversal.level_stack_need(depth + 1, dual)


def _nested_rays(n=1024, levels=17, ratio=0.3, size=1e4, seed=5):
    """Rays at every shell's scale: from around the nest's corner toward a
    shell, with limits at that scale, so no hit is ill-conditioned (a ray
    from far away would hit a tiny triangle with most of its digits lost to
    cancellation)."""
    rng = np.random.default_rng(seed)
    s = size * ratio ** rng.integers(0, levels, n)
    o = s[:, None] * rng.uniform(-0.5, 1.5, (n, 3))
    target = s[:, None] * np.stack([rng.uniform(0.5, 1, n), rng.uniform(0, 1, n),
                                    rng.uniform(0, 1, n)], 1)
    d = target - o
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return (o.astype(np.float32), d.astype(np.float32),
            (1e-6 * s).astype(np.float32), (4 * s).astype(np.float32))


@pytest.mark.parametrize("any_hit", [False, True])
def test_deep_tree_walk_matches_jax(deep_trees, any_hit):
    pos, idx, jax_tree, _ = deep_trees
    tree = torch_bvh.build_bvh(pos, idx, device="cpu")
    assert tree.wide_depth > 14
    o, d, t_min, t_max = _nested_rays()
    got = [x.numpy() for x in traversal.traverse(
        tree, torch.tensor(o), torch.tensor(d), torch.tensor(t_min), torch.tensor(t_max),
        any_hit=any_hit, row_cursors=8, steady_drain=3, dual=True)]
    want = jax_bvh.traverse(jax_tree, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_min),
                            jnp.asarray(t_max), any_hit=any_hit)
    assert (got[1] >= 0).sum() > 300
    _assert_same_hits(got, want, any_hit)


# -- the port's walk against the JAX kernels ------------------------------------


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


def _pallas(tree, o, d, t_max, any_hit, **options):
    """The JAX package's kernel for `options`, in Pallas interpret mode."""
    from jax.experimental import pallas as pl

    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    ptrav.pl.pallas_call = patched
    try:
        return ptrav.traverse_packet_pallas(
            tree, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max),
            any_hit=any_hit, **options)
    finally:
        ptrav.pl.pallas_call = orig


_VARIANTS = [
    ("k1q", dict(row_cursors=8, steady_drain=3, dual=True, q32=True), False),
    ("k1q", dict(row_cursors=8, steady_drain=3, dual=True, q32=True), True),
    ("k2_sd", dict(row_cursors=0, steady_drain=3), False),
    ("k2_sd", dict(row_cursors=0, steady_drain=2), True),
    ("k2_sdd", dict(row_cursors=0, steady_drain=3, dual=True), False),
    ("k2_sdd", dict(row_cursors=0, steady_drain=3, dual=True, drain_first=True), True),
    ("k3_binary", dict(wide=False, row_cursors=0, steady_drain=0), False),
    ("k3_binary_ordered", dict(wide=False, ordered=True, row_cursors=0, steady_drain=0),
     False),
    ("k3_wide", dict(row_cursors=0, steady_drain=0), False),
    ("k3_wide_ordered", dict(row_cursors=0, steady_drain=0, ordered=True), False),
    ("k3_wide_dual", dict(row_cursors=0, steady_drain=0, dual=True), True),
    ("k3_wide_dual", dict(row_cursors=0, steady_drain=0, dual=True), False),
]


@pytest.mark.parametrize("kernel,options,any_hit", _VARIANTS)
def test_port_matches_jax_kernel_option(kernel, options, any_hit, jax_sah):
    pos, idx = _soup(48, seed=len(kernel) + 3 * any_hit)
    jax_tree = jax_bvh.build_bvh(pos, idx, leaf_size=12)
    tree = torch_bvh.build_bvh(pos, idx, device="cpu")
    o, d, t_max = _aimed_rays(pos, seed=7 + any_hit)
    port_options = {k: v for k, v in options.items() if k != "drain_first"}
    assert traversal.select_kernel(tree, any_hit, **port_options) == kernel
    got = [x.numpy() for x in traversal.traverse(
        tree, torch.tensor(o), torch.tensor(d), 1e-3, torch.tensor(t_max),
        any_hit=any_hit, **options)]
    assert (got[1] >= 0).sum() > 150
    _assert_same_hits(got, _pallas(jax_tree, o, d, t_max, any_hit, **options), any_hit)


def test_stats_need_a_kernel():
    pos, idx = _soup(24, seed=9)
    tree = torch_bvh.build_bvh(pos, idx, device="cpu")
    o, d, t_max = _rays(n=64, seed=10)
    with pytest.raises(ValueError, match="plain walk"):
        traversal.traverse(tree, torch.tensor(o), torch.tensor(d), stats=True)
    with pytest.raises(ValueError, match="binary walks have no stats"):
        traversal.select_kernel(tree, wide=False, stats=True)


@pytest.mark.parametrize("make", ["closest", "any"])
def test_hit_queries_take_the_kernel_options(make, monkeypatch):
    """make_closest_hit / make_any_hit pass their options to traverse, with
    dual and drain_first derived as in the JAX package."""
    pos, idx = _soup(24, seed=11)
    tree = torch_bvh.build_bvh(pos, idx, device="cpu")
    seen = []
    real = traversal.traverse

    def spy(*a, **k):
        seen.append(k)
        return real(*a, **k)

    monkeypatch.setattr(traversal, "traverse", spy)
    r = Renderer()
    r.add_model(ModelLoader.load_cube(), np.eye(4, dtype=np.float32))
    r.ensure_mc_material()
    packed = r.pack(device="cpu")
    o = torch.zeros((4, 3))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(4, 3).contiguous()
    if make == "closest":
        torch_bvh.make_closest_hit(tree, row_cursors=0, steady_drain=2)(packed, o, d)
        want = dict(wide=True, ordered=False, dual=True, steady_drain=2, row_cursors=0,
                    q32=False)
    else:
        torch_bvh.make_any_hit(tree, steady_drain=3, q32=True)(packed, o, d)
        want = dict(wide=True, ordered=False, dual=True, steady_drain=3, drain_first=True,
                    row_cursors=8, q32=True, any_hit=True)
    assert len(seen) == 1
    assert seen[0] == want
