"""The traversal layer's schedules: K3-lq and K3-multi under `traverse`,
windowed compaction, the seed test, and the PT frame that turns the last
two on; the port against the JAX package on the CPU.

- `select_kernel` must name the kernel the JAX rule launches for
  `leaf_queue` and `multi` (read as in tests/test_torch_traversal_variants.py,
  by replacing each JAX kernel maker with one that records its name), with
  `multi` halved on a front of too few blocks, and K3-multi's rays per
  thread equal to the JAX kernel's blocks per grid step.
- On CPU tensors `traverse` takes its plain walk under these options; it is
  held against the JAX kernel in Pallas interpret mode on the JAX tests' own
  small cases (tests/test_pallas_traversal.py), and against the JAX plain
  packet walk for the cases interpret mode is too slow for.
- Compaction: the walk's permuted front and the forward map equal the JAX
  package's bit for bit; hits equal the uncompacted walk's.
- The seed test: rows, triangles and verdicts equal the JAX package's; a
  verdict is a true occlusion; seed-then-walk is the plain any-hit.
- The PT frame at the StaticConfig defaults (compaction and seed on) renders
  what it renders with the four fields off, and runs both.
- The entry points default to the card.

The kernels themselves are held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu import Camera as JaxCamera
from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu.models import create_scene as jax_create_scene
from rust_renderer_tpu.ops import bvh as jax_bvh
from rust_renderer_tpu.ops import compaction as jax_compaction
from rust_renderer_tpu.ops.pallas import traversal as ptrav

from rust_renderer_tpu_torch import Camera, Renderer
from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.convert import bvh_from_numpy
from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.models import create_scene
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.ops import compaction, traversal
from rust_renderer_tpu_torch.ops.ibl import compute_environment
from rust_renderer_tpu_torch.settings import StaticConfig
from test_torch_host import ensure_jax_native_sah
from test_torch_traversal_variants import _MAKERS as _VARIANT_MAKERS
from test_torch_traversal_variants import _Chosen, _pallas, _soup

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def jax_sah():
    ensure_jax_native_sah()


def _rays(n=1024, seed=1):
    """tests/test_pallas_traversal.py::_rays."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return o, d


def _trees(n, seed):
    """The JAX package's tree of the soup (its default build, as the JAX
    tests build it) and the port's copy of its tables."""
    pos, idx = _soup(n, seed)
    jax_tree = jax_bvh.build_bvh(pos, idx)
    fields = ("node_packed", "leaf_packed", "wnode_packed", "max_depth", "wide_depth",
              "q32_depth", "wnode_meta", "wnode_q32", "wnode_meta32", "q32_leaf_perm")
    return jax_tree, bvh_from_numpy({k: getattr(jax_tree, k) for k in fields}, "cpu")


def _assert_same_hits(got, want, any_hit=False):
    """Hit flags equal; for closest hits prim equal and t to rtol 1e-5. The
    JAX tests' rays start anywhere, some next to a triangle, where XLA's
    arithmetic and PyTorch's round t apart by 1-3e-6 relative (a few hits in
    a thousand; tests/test_torch_traversal_variants.py::_aimed_rays)."""
    p1, p2 = np.asarray(got[1]), np.asarray(want[1])
    np.testing.assert_array_equal(p1 >= 0, p2 >= 0)
    if any_hit:
        return
    np.testing.assert_array_equal(p1, p2)
    hit = p2 >= 0
    np.testing.assert_allclose(np.asarray(got[0])[hit], np.asarray(want[0])[hit], rtol=1e-5)


# -- the kernel rule ------------------------------------------------------------


_MAKERS = {
    **_VARIANT_MAKERS,
    "_make_kernel_wide_lq": lambda leaf_size, any_hit, flush_k, **k: f"k3_wide_lq:{flush_k}",
    "_make_kernel_wide_multi": lambda leaf_size, any_hit, nblocks, **k:
        f"k3_wide_multi:{nblocks}",
}


def _jax_kernel(tree, monkeypatch, any_hit, shape, **options) -> str:
    """The port's name of the kernel the JAX package's
    traverse_packet_pallas launches with `options` on a front of `shape`,
    with its flush size or blocks per step."""
    for name, port_name in _MAKERS.items():
        def record(*a, _name=port_name, **k):
            raise _Chosen(_name(*a, **k))

        monkeypatch.setattr(ptrav, name, record)
    o, d = _rays(int(np.prod(shape)), seed=2)
    with jax.disable_jit(), pytest.raises(_Chosen) as chosen:
        ptrav.traverse_packet_pallas(tree, jnp.asarray(o).reshape(*shape, 3),
                                     jnp.asarray(d).reshape(*shape, 3), any_hit=any_hit,
                                     **options)
    return str(chosen.value)


def _port_kernel(tree, any_hit, shape, **options) -> str:
    options.setdefault("steady_drain", 0)  # traverse_packet_pallas's defaults
    options.setdefault("row_cursors", 0)
    kernel = traversal.select_kernel(tree, any_hit, ray_shape=shape, **options)
    if kernel == "k3_wide_lq":
        return f"{kernel}:{options['leaf_queue']}"
    if kernel == "k3_wide_multi":
        return f"{kernel}:{traversal.multi_rays(shape, options['multi'])}"
    return kernel


# (JAX options, any_hit, front shape, expected port kernel)
_RULE_ROWS = [
    *[(dict(leaf_queue=k), a, (5 * 1024,), f"k3_wide_lq:{k}")
      for k in (1, 4, 8) for a in (False, True)],
    (dict(leaf_queue=4, dual=True), True, (5 * 1024,), "k3_wide_lq:4"),  # lq before dual
    (dict(leaf_queue=4, steady_drain=3), False, (5 * 1024,), "k2_sd"),  # drain before lq
    (dict(leaf_queue=4, ordered=True), False, (5 * 1024,), "k3_wide_ordered"),
    (dict(leaf_queue=4, stats=True), False, (5 * 1024,), "k3_wide_lq:4"),
    (dict(leaf_queue=4, wide=False), False, (5 * 1024,), "k3_binary"),
    *[(dict(multi=m), a, (5 * 1024,), f"k3_wide_multi:{m}")
      for m in (2, 4, 8) for a in (False, True)],
    (dict(multi=8), False, (64, 64), "k3_wide_multi:4"),  # 4 blocks: 8 halves to 4
    (dict(multi=8), False, (32, 96), "k3_wide"),  # 3 blocks: 8 halves to 1
    (dict(multi=4), False, (1080, 32), "k3_wide_multi:4"),  # not tiled: padded
    (dict(multi=4, steady_drain=3, dual=True), True, (5 * 1024,), "k3_wide_multi:4"),
    (dict(multi=4, dual=True), False, (5 * 1024,), "k3_wide_multi:4"),
    (dict(multi=4, leaf_queue=4), False, (5 * 1024,), "k3_wide_multi:4"),
    (dict(multi=4, row_cursors=8, steady_drain=3, dual=True), False, (5 * 1024,), "k1"),
    (dict(multi=4, ordered=True), False, (5 * 1024,), "k3_wide_ordered"),
    (dict(multi=4, stats=True), False, (5 * 1024,), "k3_wide"),
    (dict(multi=4, wide=False), False, (5 * 1024,), "k3_binary"),
]


@pytest.fixture(scope="module")
def rule_trees(jax_sah):
    return _trees(150, 4)


@pytest.mark.parametrize("options,any_hit,shape,want", _RULE_ROWS)
def test_select_kernel_follows_the_jax_rule_for_lq_and_multi(options, any_hit, shape, want,
                                                             rule_trees, monkeypatch):
    jax_tree, port_tree = rule_trees
    assert _jax_kernel(jax_tree, monkeypatch, any_hit, shape, **options) == want
    assert _port_kernel(port_tree, any_hit, shape, **options) == want


# -- the port's walk against the JAX kernels --------------------------------------


def _port(tree, o, d, t_max=1e4, **options):
    t_max = torch.tensor(t_max) if isinstance(t_max, np.ndarray) else t_max
    return [x.numpy() for x in traversal.traverse(tree, torch.tensor(o), torch.tensor(d),
                                                  1e-3, t_max, **options)]


def test_lq_matches_the_jax_kernel(jax_sah):
    """tests/test_pallas_traversal.py::test_pallas_leaf_queue_matches: the
    24-triangle soup, closest hits, leaf_queue=4."""
    jax_tree, tree = _trees(24, 23)
    o, d = _rays(seed=24)
    options = dict(row_cursors=0, steady_drain=0, leaf_queue=4)
    assert traversal.select_kernel(tree, **options) == "k3_wide_lq"
    got = _port(tree, o, d, **options)
    assert (got[1] >= 0).sum() > 5
    _assert_same_hits(got, _pallas(jax_tree, o, d, 1e4, False, leaf_queue=4))


@pytest.mark.parametrize("k,any_hit", [(1, False), (8, False), (4, True)])
def test_lq_sweep_matches_the_jax_packet_walk(k, any_hit, jax_sah):
    """tests/test_pallas_traversal.py::test_pallas_leaf_queue_sweep_tpu's
    cases (the 60-triangle soup), against the JAX plain packet walk."""
    jax_tree, tree = _trees(60, 25)
    o, d = _rays(seed=26)
    got = _port(tree, o, d, any_hit=any_hit, row_cursors=0, steady_drain=0, leaf_queue=k)
    want = jax_bvh.traverse_packet(jax_tree, jnp.asarray(o), jnp.asarray(d), any_hit=any_hit)
    assert (got[1] >= 0).sum() > 5
    _assert_same_hits(got, want, any_hit)


@pytest.mark.parametrize("m", [2, 4])
def test_multi_matches_the_jax_kernel(m, jax_sah):
    """tests/test_pallas_traversal.py::test_pallas_multi_block_matches."""
    jax_tree, tree = _trees(150, 13)
    o, d = _rays(seed=14)
    assert traversal.select_kernel(tree, row_cursors=0, multi=m, ray_shape=(1024,)) \
        == "k3_wide_multi"
    got = _port(tree, o, d, row_cursors=0, multi=m)
    _assert_same_hits(got, _pallas(jax_tree, o, d, 1e4, False, multi=m))


def test_multi_any_hit_with_retired_lanes_matches_the_jax_kernel(jax_sah):
    """tests/test_pallas_traversal.py::
    test_pallas_multi_block_any_hit_and_degenerate."""
    jax_tree, tree = _trees(150, 15)
    o, d = _rays(seed=16)
    d[::5] = 0.0
    t_max = np.full(o.shape[0], 3.0, np.float32)
    got = _port(tree, o, d, t_max, any_hit=True, row_cursors=0, multi=4)
    want = _pallas(jax_tree, o, d, t_max, True, multi=4)
    _assert_same_hits(got, want, any_hit=True)
    assert np.all(got[1][::5] == -1)


# -- compaction -------------------------------------------------------------------


def _capture(outputs, zeros):
    """A traversal that records the front it is given and returns no hits."""
    def trav(bvh, o, d, t_min, t_max, **kw):
        outputs.append((np.asarray(o), np.asarray(d), np.asarray(t_max, np.float32)))
        n = o.shape[0]
        return zeros(n, np.float32), zeros(n, np.int32) - 1, zeros(n, np.float32), \
            zeros(n, np.float32)
    return trav


@pytest.mark.parametrize("shape", [(2048,), (64, 32)])
@pytest.mark.parametrize("order", ["live", "morton"])
@pytest.mark.parametrize("per_lane_tmax", [False, True])
def test_compaction_permutes_as_jax(shape, order, per_lane_tmax):
    """The front the walk gets (origins, directions, per-lane t_max) equals
    the JAX package's bit for bit: 2,048 rays in windows of 2 blocks, every
    third lane dead; flat and tile-major."""
    o, d = _rays(2048, seed=32)
    d[::3] = 0.0
    o, d = o.reshape(*shape, 3), d.reshape(*shape, 3)
    t_max = np.random.default_rng(5).uniform(1, 9, shape).astype(np.float32)
    lim = t_max if per_lane_tmax else 1e4
    want, got = [], []
    jax_compaction.traverse_compacted(
        None, jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(lim) if per_lane_tmax else lim,
        window_blocks=2, trav=_capture(want, lambda n, t: jnp.zeros(n, t)), order=order)
    compaction.traverse_compacted(
        None, torch.tensor(o), torch.tensor(d), 1e-3,
        torch.tensor(lim) if per_lane_tmax else lim, window_blocks=2,
        trav=_capture(got, lambda n, t: torch.zeros(n, dtype=getattr(torch, np.dtype(t).name))),
        order=order)
    for a, b in zip(got[0], want[0]):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))


def test_window_forward_map_matches_jax():
    live = np.asarray([True, False, True, False, False, True, True, True])
    fwd = compaction.window_forward_map(torch.tensor(live), 4).numpy()
    np.testing.assert_array_equal(fwd, [0, 2, 1, 3, 7, 4, 5, 6])
    live = np.random.default_rng(3).uniform(size=2048) > 0.4
    live[::3] = False
    np.testing.assert_array_equal(
        compaction.window_forward_map(torch.tensor(live), 1024).numpy(),
        np.asarray(jax_compaction.window_forward_map(jnp.asarray(live), 1024)))


@pytest.mark.parametrize("method,order", [("sort", "live"), ("sort", "morton"),
                                          ("scatter", "live")])
@pytest.mark.parametrize("any_hit", [False, True])
def test_compacted_walk_equals_the_walk(method, order, any_hit):
    pos, idx = _soup(3000, 31)
    tree = torch_bvh.build_bvh(pos, idx, device="cpu")
    o, d = (torch.tensor(x) for x in _rays(2048, seed=32))
    d[::3] = 0.0
    t_max = torch.tensor(np.random.default_rng(6).uniform(2, 20, 2048).astype(np.float32))
    want = traversal.traverse(tree, o, d, 1e-3, t_max, any_hit=any_hit)
    got = compaction.traverse_compacted(tree, o, d, 1e-3, t_max, window_blocks=2,
                                        method=method, order=order, any_hit=any_hit)
    assert torch.equal(got[1], want[1])
    assert bool((got[1][::3] == -1).all())
    assert int((want[1] >= 0).sum()) > 300
    if not any_hit:
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def test_compaction_windows_snap_as_jax():
    assert compaction.window_blocks_for(1920 * 1080, 64) == 45
    assert compaction.window_blocks_for(1920 * 1080, 128) == 81
    assert compaction.window_blocks_for(2 * 1920 * 1080, 128) == 90
    assert compaction.window_blocks_for(1000, 64) == 1
    assert compaction.window_blocks_for(3 * 1024, 2) == 1


# -- the seed test -----------------------------------------------------------------


def _jax_seed_tris(seed_fn):
    """The triangles the JAX package's seed test closed over."""
    cells = dict(zip(seed_fn.__code__.co_freevars, seed_fn.__closure__))
    return cells["tris"].cell_contents


@pytest.fixture(scope="module")
def seed_cases(jax_sah):
    """The JAX seed test's soup (tests/test_pallas_traversal.py::
    test_seed_occlusion_matches) and the default scene, with rays."""
    pos, idx = _soup(400, 41)
    soup = (jax_bvh.build_bvh(pos, idx, leaf_size=12), torch_bvh.build_bvh(pos, idx, device="cpu"),
            *_rays(2048, seed=42))
    jr = JaxRenderer()
    jax_create_scene(jr, JaxCamera([0, 0, 0], [0, 0, -1]))
    jr.ensure_mc_material()
    scene = jr.pack()
    positions, indices = np.asarray(scene.positions), np.asarray(scene.indices)
    rng = np.random.default_rng(43)
    o = rng.uniform(-10, 10, (2048, 3)).astype(np.float32) * [1, 0.3, 1] + [0, 2, 0]
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    default = (jax_bvh.build_bvh(positions, indices, leaf_size=12),
               torch_bvh.build_bvh(positions, indices, device="cpu"), o.astype(np.float32), d)
    return {"soup": soup, "default": default}


@pytest.mark.parametrize("case", ["soup", "default"])
def test_seed_test_matches_jax(case, seed_cases):
    jax_tree, tree, o, d = seed_cases[case]
    jax_seed = jax_bvh.make_seed_test(jax_tree, 4)
    want_tris = _jax_seed_tris(jax_seed)
    rows = tree.leaf_area_order[:4]
    lp = tree.leaf_packed.numpy()
    ids = lp[:, 9 * 12:].view(np.int32)
    got_tris = [(lp[r, 9 * s:9 * s + 9], int(ids[r, s])) for r in rows for s in range(12)
                if ids[r, s] >= 0]
    assert 0 < len(got_tris) <= 48
    assert [t for _, t in got_tris] == [t[3] for t in want_tris]
    for (geo, _), (v0, e1, e2, _) in zip(got_tris, want_tris):
        np.testing.assert_array_equal(geo, np.asarray(v0 + e1 + e2, np.float32))
    t_max = np.random.default_rng(7).uniform(1, 30, o.shape[0]).astype(np.float32)
    want = np.asarray(jax_seed(jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max)))
    np.testing.assert_array_equal(
        torch_bvh.seed_table(tree, 4).numpy().T,
        np.asarray([v0 + e1 + e2 for v0, e1, e2, _ in want_tris], np.float32))
    got = torch_bvh.make_seed_test(tree, 4)(torch.tensor(o), torch.tensor(d), 1e-3,
                                            torch.tensor(t_max))[0].numpy()
    np.testing.assert_array_equal(got, want)
    occluded = traversal.traverse(tree, torch.tensor(o), torch.tensor(d), 1e-3,
                                  torch.tensor(t_max), any_hit=True)[1].numpy() >= 0
    assert got.any()
    assert not (got & ~occluded).any()


@pytest.mark.parametrize("case", ["soup", "default"])
def test_seed_walk_direction_is_the_jax_rewrite(case, seed_cases):
    """The seed test's fused output: the direction the walk takes is the
    JAX package's `make_any_hit` rewrite (zero where seeded, the ray's own
    direction elsewhere, bit for bit), beside verdicts equal to JAX's; rays
    with a zero direction among them."""
    jax_tree, tree, o, d = seed_cases[case]
    d = d.copy()
    d[::37] = 0.0
    t_max = np.random.default_rng(9).uniform(1, 30, o.shape[0]).astype(np.float32)
    want = jax_bvh.make_seed_test(jax_tree, 4)(jnp.asarray(o), jnp.asarray(d), 1e-3,
                                              jnp.asarray(t_max))
    want_d = np.asarray(jnp.where(want[..., None], 0.0, jnp.asarray(d)))
    occ, walk_d = torch_bvh.seed_occlusion_plain(
        torch_bvh.seed_table(tree, 4), torch.tensor(o), torch.tensor(d),
        torch.full((o.shape[0],), 1e-3), torch.tensor(t_max))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(want))
    np.testing.assert_array_equal(walk_d.numpy().view(np.int32), want_d.view(np.int32))
    assert occ.any() and not occ.all()
    assert not occ.numpy()[::37].any()


@pytest.mark.parametrize("k", [12, 40])
def test_seed_test_reaches_any_k(k, seed_cases):
    """The seed test takes any number of rows, as the JAX package's does:
    at and past the 96 triangles one launch of the seed kernel holds (12
    rows here give 96, 40 rows several launches' worth), its table
    is the JAX seed test's triangles and its verdicts are the JAX
    verdicts. A tree whose seed rows hold no triangle has no seed test."""
    jax_tree, tree, o, d = seed_cases["default"]
    jax_seed = jax_bvh.make_seed_test(jax_tree, k)
    want_tris = _jax_seed_tris(jax_seed)
    tris = torch_bvh.seed_table(tree, k)
    assert tris.shape[1] == len(want_tris) >= torch_bvh.SEED_LAUNCH_TRIS
    np.testing.assert_array_equal(
        tris.numpy().T, np.asarray([v0 + e1 + e2 for v0, e1, e2, _ in want_tris], np.float32))
    t_max = np.random.default_rng(11).uniform(1, 30, o.shape[0]).astype(np.float32)
    want = np.asarray(jax_seed(jnp.asarray(o), jnp.asarray(d), 1e-3, jnp.asarray(t_max)))
    got = torch_bvh.make_seed_test(tree, k)(torch.tensor(o), torch.tensor(d), 1e-3,
                                            torch.tensor(t_max))[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert got.any()
    empty = tree._replace(seed_rows=np.concatenate(
        [tree.seed_rows[:, :108], np.full((tree.seed_rows.shape[0], 12), -1,
                                          np.int32).view(np.float32)], 1))
    assert torch_bvh.seed_table(empty, k) is None
    assert torch_bvh.make_seed_test(empty, k) is None


@pytest.mark.parametrize("compact_window", [0, 2])
def test_seeded_any_hit_is_the_plain_any_hit(compact_window, seed_cases):
    _, tree, o, d = seed_cases["default"]
    r = Renderer()
    create_scene(r, Camera([0, 0, 0], [0, 0, -1]))
    r.ensure_mc_material()
    scene = r.pack(device="cpu")
    o, d = torch.tensor(o), torch.tensor(d)
    want = torch_bvh.make_any_hit(tree)(scene, o, d)
    got = torch_bvh.make_any_hit(tree, seed_rows=4, compact_window=compact_window)(
        scene, o, d)
    assert torch.equal(got, want)
    assert bool(torch_bvh.make_seed_test(tree, 4)(o, d, 1e-3, 1e4)[0].any())
    assert torch_bvh.make_seed_test(tree, 0) is None


# -- K1's diagnostic outputs -------------------------------------------------------


@pytest.mark.parametrize("any_hit", [False, True])
def test_k1_diagnostic_outputs_on_cpu_tensors(any_hit):
    """traverse's K1 diagnostics (the JAX row kernel's `overflow_stats` and
    `phase_stats`) on CPU tensors: phase_stats raises, as stats does (the
    plain walk has no schedule to count); overflow_stats returns the plain
    walk's hits and a fifth value None (K1 never clamps); stats and
    phase_stats at once raise."""
    pos, idx = _soup(200, 3)
    tree = torch_bvh.build_bvh(pos, idx, device="cpu")
    o, d = (torch.tensor(x) for x in _rays(256, 4))
    with pytest.raises(ValueError, match="stats"):
        traversal.traverse(tree, o, d, any_hit=any_hit, phase_stats=True)
    got = traversal.traverse(tree, o, d, any_hit=any_hit, overflow_stats=True)
    assert len(got) == 5 and got[4] is None
    for a, b in zip(got[:4], traversal.traverse(tree, o, d, any_hit=any_hit)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="one diagnostic"):
        traversal.traverse(tree, o, d, any_hit=any_hit, stats=True, phase_stats=True)


# -- the PT frame -----------------------------------------------------------------


def test_pt_frame_runs_compaction_and_seed_at_the_defaults(monkeypatch):
    """At the StaticConfig defaults the PT frame walks within compaction
    windows and seeds its any-hit queries; the frame is the one it renders
    with the four fields off (tests/test_torch_slice.py holds it to the JAX
    frame)."""
    windows, seeds = [], []
    compacted = compaction.traverse_compacted
    seeded = torch_bvh.seed_occlusion_plain

    def spy_compact(bvh, origin, *a, window_blocks, **k):
        windows.append((tuple(origin.shape[:-1]), window_blocks, k.get("any_hit", False)))
        return compacted(bvh, origin, *a, window_blocks=window_blocks, **k)

    def spy_seed(*a):
        seeds.append(a[1].shape[0])
        return seeded(*a)

    monkeypatch.setattr(compaction, "traverse_compacted", spy_compact)
    monkeypatch.setattr(torch_bvh, "seed_occlusion_plain", spy_seed)

    def frame(**fields):
        app = Application(64, 64, cfg=StaticConfig(num_bounces=2, **fields), device="cpu")
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        return app.render_frame()["present_output"]

    on = frame()
    # Per bounce one closest-hit front and one doubled any-hit front; the
    # gbuffer's primary front keeps the defaults, as in the JAX package.
    assert windows == [((64, 64), 64, False), ((128, 64), 128, True)] * 2
    assert seeds == [2 * 64 * 64] * 2
    windows.clear()
    seeds.clear()
    off = frame(compact_window=0, compact_window_any=0, seed_rows=0)
    assert windows == [] and seeds == []
    assert torch.equal(on, off)


# -- the entry points' device ------------------------------------------------------


def test_entry_points_default_to_the_card():
    """Application, Graph, Renderer.pack, build_bvh and compute_environment
    run on CUDA unless the caller asks for the CPU; where torch sees no GPU
    they raise, and nothing falls back."""
    pos, idx = _soup(20, 1)
    assert Graph().device.type == "cuda"
    r = Renderer()
    create_scene(r, Camera([0, 0, 0], [0, 0, -1]))
    calls = (lambda: Application(16, 16), lambda: r.pack(),
             lambda: torch_bvh.build_bvh(pos, idx),
             lambda: compute_environment(StaticConfig(cubemap_size=8, cubemap_mips=2,
                                                      irradiance_size=4, brdf_lut_size=8),
                                         np.asarray([0.0, 1.0, 0.0], np.float32)))
    if torch.cuda.is_available():
        assert Application(16, 16).device.type == "cuda"
        assert torch_bvh.build_bvh(pos, idx).device.type == "cuda"
        return
    for call in calls:
        with pytest.raises((RuntimeError, AssertionError)):
            call()
