"""Row bands of the path-traced frame over torch.distributed ranks
(``rust_renderer_tpu_torch/parallel/``) against the port's one-process
frame and the JAX package's ``parallel/`` on its 4-device CPU mesh.

The inputs are the JAX package's scenes, BVH tables (leaf size 12, the
port's layout) and views, carried across as numpy. The sharded cases run
once, on 4 gloo ranks spawned for the whole module (a file store under the
test's temporary directory, no network port; one CPU thread a rank); the
rank functions live here, and this module imports jax only inside its
tests and fixtures, so a rank never imports it.

Tolerances: the port's n-rank frame against its one-rank frame, the
spatial reservoirs' Y bit-equal and the output within 2e-5 (the JAX
package's bound, tests/test_parallel.py); the port against the JAX package,
Y bit-equal and the output within the slice tolerance (99% of pixels within
1e-3, mean |diff| <= 1e-3, tests/test_torch_slice.py).
"""

import sys

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.convert import (
    bvh_from_numpy, packed_scene_from_numpy, reservoir_from_numpy, view_from_numpy)
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.ops import pathtrace, restir
from rust_renderer_tpu_torch.parallel import (
    flagship_step, make_tile_group, render_flagship_tiled, render_tiled,
    shard_flagship_inputs, spawn_ranks, tiles)
from rust_renderer_tpu_torch.settings import StaticConfig

torch.set_num_threads(1)

SIZE, RANKS, FRAMES = 32, 4, 2
BVH_FIELDS = ("node_packed", "leaf_packed", "wnode_packed", "max_depth", "wide_depth")
SUN = np.array([0.0, 0.90631, 0.42262], np.float32)


def _numpy(fields) -> dict:
    return {k: np.asarray(v) for k, v in fields.items()}


def _jax_case(flagship: bool) -> dict:
    """The JAX package's flagship case (the cube scene with 4 lights, 2
    bounces; tests/test_parallel.py:57-73) or its tiles case (the RTIOW
    spheres, 1 bounce, no lights; :16-26) at SIZE², as numpy, with the JAX
    objects under "jax"."""
    import jax.numpy as jnp

    import rust_renderer_tpu as jrt
    from rust_renderer_tpu.models import create_cube_scene, create_rtiow_scene
    from rust_renderer_tpu.ops import bvh as jbvh
    from rust_renderer_tpu.settings import RenderSettings, StaticConfig as JaxStaticConfig

    r = jrt.Renderer()
    if flagship:
        cam = jrt.Camera([-2.5, 3.0, -2.5], [10.0, 1.0, 10.0], aspect_ratio=1.0)
        create_cube_scene(r, cam)
        for i in range(4):
            r.add_light([float(i) * 4.0, 3.0, float(i % 2) * 4.0], [1.0, 1.0, 1.0])
    else:
        cam = jrt.Camera([0, 1, 4], [0, 0.5, -1], aspect_ratio=1.0)
        create_rtiow_scene(r, cam)
    scene = r.pack()
    tree = jbvh.build_bvh(np.asarray(scene.positions), np.asarray(scene.indices),
                          leaf_size=12)
    bounces = 2 if flagship else 1
    cfg = JaxStaticConfig(width=SIZE, height=SIZE, samples_per_frame=1, num_bounces=bounces)
    view = RenderSettings.default(num_lights=r.get_num_lights()).with_camera(cam, SIZE, SIZE)
    view = view.replace(total_samples=jnp.uint32(1))
    if not flagship:
        view = view.replace(lights_enabled=jnp.int32(0))
    views = [view.replace(total_samples=jnp.uint32(k + 1)) for k in range(FRAMES)]
    return {
        "scene": _numpy({k: getattr(scene, k) for k in scene.__dataclass_fields__}),
        "bvh": {k: np.asarray(getattr(tree, k)) for k in BVH_FIELDS},
        "views": [_numpy(vars(v)) for v in views],
        "bounces": bounces, "num_lights": r.get_num_lights(),
        "jax": dict(scene=scene, tree=tree, cfg=cfg, views=views),
    }


def _port(case: dict, device="cpu"):
    """(scene, bvh, views, cfg) of a case on the port's side."""
    return (packed_scene_from_numpy(case["scene"], device),
            bvh_from_numpy(case["bvh"], device),
            [view_from_numpy(v, device) for v in case["views"]],
            StaticConfig(width=SIZE, height=SIZE, samples_per_frame=1,
                         num_bounces=case["bounces"]))


def _flagship_frames(scene, bvh, views, cfg, group=None):
    """FRAMES flagship frames from a zero state: each frame's (output,
    spatial Y) as numpy, the whole image on every rank. With a group, the
    bands go through render_flagship_tiled and are gathered, and the
    bytes the chain gathered a frame are recorded."""
    closest, any_hit = torch_bvh.make_closest_hit(bvh), torch_bvh.make_any_hit(bvh)
    accum = torch.zeros((SIZE, SIZE, 3))
    res = restir.Reservoir.empty((SIZE, SIZE), device="cpu")
    if group is not None:
        accum, res = shard_flagship_inputs(group, accum, res)
    out, gathered = [], []
    for view in views:
        if group is None:
            img, accum, res = flagship_step(scene, view, cfg, accum, res, closest, any_hit)
            out.append((img.numpy(), res.Y.numpy()))
            continue
        tiles.GATHERED_BYTES = 0
        img, accum, res = render_flagship_tiled(scene, view, cfg, accum, res, closest,
                                                any_hit, group)
        gathered.append(tiles.GATHERED_BYTES)
        out.append((tiles.gather_rows(img, group).numpy(),
                    tiles.gather_rows(res.Y, group).numpy()))
    return out, gathered


def _pt_graph_frames(scene, bvh, views, cfg, num_lights, group=None):
    """FRAMES frames of the port's PT graph (row-sharded over `group` where
    given): each frame's whole present_output, spatial Y and pt_rays, and
    the shapes of the band's image-space resources."""
    from rust_renderer_tpu_torch.graph import Graph
    from rust_renderer_tpu_torch.renderers import build_path_tracing_render_graph

    g = Graph(device="cpu")
    if group is not None:
        g.shard_image_rows(group, SIZE, SIZE)
    whole = (lambda t: t) if group is None else (lambda t: tiles.gather_rows(t, group))
    frames = []
    for view in views:
        g.new_frame()
        g.clear()
        build_path_tracing_render_graph(g, cfg, None, bvh, SUN, num_lights=num_lights)
        res = g.render(scene, view)
        frames.append((whole(res["present_output"]).numpy(),
                       whole(res["spatial_reuse_reservoirs_Y"]).numpy(),
                       float(res["pt_rays"])))
    shapes = {k: tuple(v.shape) for k, v in res.items()
              if k in ("present_output", "accumulation_image", "gbuffer_position")}
    return frames, shapes


def _rank(rank, n, flagship_case, tiles_case):
    """Every sharded case on one rank; the gathered results."""
    group, index = make_tile_group(device="cpu")
    scene, bvh, views, cfg = _port(flagship_case)
    flagship, gathered = _flagship_frames(scene, bvh, views, cfg, group)
    graph, graph_shapes = _pt_graph_frames(scene, bvh, views, cfg,
                                           flagship_case["num_lights"], group)

    # shard_flagship_inputs of a whole-frame state numbered by row.
    rows = torch.arange(SIZE, dtype=torch.float32)[:, None].expand(SIZE, SIZE)
    acc, res = shard_flagship_inputs(group, rows[..., None].expand(SIZE, SIZE, 3).clone(),
                                     restir.Reservoir(rows.to(torch.int32), rows, rows,
                                                      rows.to(torch.int32)))

    sub, sub_index = make_tile_group(2, device="cpu")
    subgroup = (None, None) if sub is None else (
        sub_index, tiles.gather_rows(torch.full((1,), float(index)), sub).tolist())

    t_scene, t_bvh, t_views, t_cfg = _port(tiles_case)
    band = SIZE // n
    tiled = render_tiled(t_scene, t_views[0], t_cfg, torch.zeros((band, SIZE, 3)), group,
                         closest_hit=torch_bvh.make_closest_hit(t_bvh))
    return {"index": index, "flagship": flagship, "gathered": gathered, "graph": graph,
            "graph_shapes": graph_shapes, "subgroup": subgroup,
            "shard_rows": [acc[:, 0, 0].numpy()] + [p[:, 0].numpy() for p in res],
            "tiled": tiles.gather_rows(tiled.output, group).numpy(),
            "tiled_rays": float(tiled.rays_traced),
            "imported_jax": "jax" in sys.modules or "rust_renderer_tpu" in sys.modules}


@pytest.fixture(scope="module")
def cases():
    return {"flagship": _jax_case(True), "tiles": _jax_case(False)}


@pytest.fixture(scope="module")
def sharded(cases, tmp_path_factory):
    strip = lambda case: {k: v for k, v in case.items() if k != "jax"}
    return spawn_ranks(_rank, RANKS, str(tmp_path_factory.mktemp("ranks")),
                       args=(strip(cases["flagship"]), strip(cases["tiles"])), threads=1)


@pytest.fixture(scope="module")
def unsharded(cases):
    scene, bvh, views, cfg = _port(cases["flagship"])
    return _flagship_frames(scene, bvh, views, cfg)[0]


@pytest.fixture(scope="module")
def jax_flagship(cases):
    """The JAX flagship chain's FRAMES frames, unsharded and over a 4-device
    mesh: (output, spatial Y) a frame."""
    import jax
    import jax.numpy as jnp

    from rust_renderer_tpu.ops import bvh as jbvh
    from rust_renderer_tpu.ops.restir import Reservoir
    from rust_renderer_tpu.parallel import (
        flagship_step as jax_step, make_tile_mesh, render_flagship_tiled as jax_tiled,
        shard_flagship_inputs as jax_shard)

    j = cases["flagship"]["jax"]
    closest, any_hit = jbvh.make_closest_hit(j["tree"]), jbvh.make_any_hit(j["tree"])
    cfg = j["cfg"]
    mesh = make_tile_mesh(RANKS)
    single = jax.jit(lambda s, v, a, r: jax_step(s, v, cfg, a, r, closest, any_hit))
    tiled = jax.jit(lambda s, v, a, r: jax_tiled(s, v, cfg, a, r, closest, any_hit, mesh))
    out = {}
    for name, step in (("single", single), ("tiled", tiled)):
        accum = jnp.zeros((SIZE, SIZE, 3), jnp.float32)
        res = Reservoir.empty((SIZE, SIZE))
        if name == "tiled":
            accum, res = jax_shard(mesh, accum, res)
        frames = []
        for view in j["views"]:
            img, accum, res = step(j["scene"], view, accum, res)
            frames.append((np.asarray(img), np.asarray(res.Y)))
        out[name] = frames
    return out


def _assert_slice_close(img, ref):
    assert img.shape == ref.shape and np.isfinite(img).all()
    diff = np.abs(img - ref)
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert diff.mean() <= 1e-3


# -- ops: row_offset / full_size, the ReSTIR band passes ------------------------


def test_path_trace_row_bands_stitch_to_the_frame_and_match_jax(cases):
    """The port's path_trace over RANKS bands (row_offset, full_size),
    stitched, is the full frame bit for bit; one band, called positionally
    in the JAX package's argument order, matches the JAX path_trace on the
    same band (slice tolerance, rays equal)."""
    import jax

    from rust_renderer_tpu.ops import bvh as jbvh
    from rust_renderer_tpu.ops import pathtrace as jax_pathtrace

    case = cases["tiles"]
    scene, bvh, views, cfg = _port(case)
    closest = torch_bvh.make_closest_hit(bvh)
    band = SIZE // RANKS
    accum = torch.zeros((SIZE, SIZE, 3))
    full = pathtrace.path_trace(scene, views[0], cfg, accum, closest_hit=closest)
    parts = [pathtrace.path_trace(scene, views[0], cfg, accum[i * band:(i + 1) * band],
                                  None, closest, None, i * band, (SIZE, SIZE))
             for i in range(RANKS)]
    assert torch.equal(torch.cat([p.output for p in parts]), full.output)
    assert torch.equal(torch.cat([p.accumulation for p in parts]), full.accumulation)
    assert sum(float(p.rays_traced) for p in parts) == float(full.rays_traced)

    j = case["jax"]
    closest_j = jbvh.make_closest_hit(j["tree"])
    want = jax.jit(lambda s, v, a: jax_pathtrace.path_trace(
        s, v, j["cfg"], a, None, closest_j, None, 2 * band, (SIZE, SIZE)))(
        j["scene"], j["views"][0], np.zeros((band, SIZE, 3), np.float32))
    _assert_slice_close(parts[2].output.numpy(), np.asarray(want.output))
    assert float(parts[2].rays_traced) == float(want.rays_traced)


@pytest.mark.parametrize("band_index", [0, RANKS - 1])
def test_restir_band_passes_match_jax(cases, band_index):
    """initial_ris_pass, temporal_reuse_pass(full_height) and
    spatial_reuse_pass(temporal_full, row_offset) on one band, each called
    positionally in the JAX package's argument order (return arities
    included), against the JAX passes: states, Y and M equal, weights to
    1e-6 relative."""
    import jax.numpy as jnp

    from rust_renderer_tpu.ops import restir as jrestir

    case = cases["flagship"]
    js = case["jax"]["scene"]
    ts, _, _, _ = _port(case)
    band = SIZE // RANKS
    top = band_index * band
    rng = np.random.default_rng(40 + band_index)
    hp = rng.uniform(-4, 12, (band, SIZE, 3)).astype(np.float32)
    state = rng.integers(0, 2**32, (band, SIZE), dtype=np.uint64).astype(np.uint32)
    full = jrestir.Reservoir(
        Y=rng.integers(-1, 4, (SIZE, SIZE)).astype(np.int32),
        W_sum=rng.uniform(0, 2, (SIZE, SIZE)).astype(np.float32),
        W_X=rng.uniform(0, 2, (SIZE, SIZE)).astype(np.float32),
        M=rng.integers(0, 25, (SIZE, SIZE)).astype(np.int32))
    view = case["views"][0]
    pv, on = view["prev_frame_projection_view"], np.int32(1)
    nl, mx = view["num_lights"], view["max_num_lights_used"]
    T = lambda x: torch.as_tensor(np.asarray(x))

    def same(got, want):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]).astype(np.int64))
        r, w = got[1], want[1]
        np.testing.assert_array_equal(r.Y.numpy(), np.asarray(w.Y))
        np.testing.assert_array_equal(r.M.numpy(), np.asarray(w.M))
        np.testing.assert_allclose(r.W_sum.numpy(), np.asarray(w.W_sum), rtol=1e-6)
        np.testing.assert_allclose(r.W_X.numpy(), np.asarray(w.W_X), rtol=1e-6)

    jhp = jnp.asarray(hp)
    want = jrestir.initial_ris_pass(js, jnp.asarray(state), jhp, nl, mx, 8)
    got = restir.initial_ris_pass(ts, T(state.astype(np.int64)), T(hp), T(nl), T(mx), 8)
    assert len(got) == len(want) == 2
    same(got, want)
    initial_j, initial_t = want[1], got[1]

    want = jrestir.temporal_reuse_pass(js, want[0], jhp, initial_j, full, pv, on, SIZE)
    got = restir.temporal_reuse_pass(ts, got[0], T(hp), initial_t, reservoir_from_numpy(full, "cpu"),
                                     T(pv), T(on), SIZE)
    assert len(got) == len(want) == 2
    same(got, want)

    temporal_full = jrestir.Reservoir(*(np.asarray(p).copy() for p in full))
    for p, q in zip(temporal_full, want[1]):
        p[top:top + band] = np.asarray(q)
    want = jrestir.spatial_reuse_pass(js, want[0], jhp, want[1], on, 5, 30, temporal_full,
                                      top)
    got = restir.spatial_reuse_pass(ts, got[0], T(hp), got[1], T(on), 5, 30,
                                    reservoir_from_numpy(temporal_full, "cpu"), top)
    same(got, want)
    assert (got[1].Y.numpy() >= 0).mean() > 0.5


def test_reservoir_from_numpy_round_trips_a_jax_reservoir():
    from rust_renderer_tpu.ops.restir import Reservoir

    rng = np.random.default_rng(3)
    want = Reservoir(Y=rng.integers(-1, 9, (5, 7)).astype(np.int32),
                     W_sum=rng.normal(size=(5, 7)).astype(np.float32),
                     W_X=rng.normal(size=(5, 7)).astype(np.float32),
                     M=rng.integers(0, 40, (5, 7)).astype(np.int32))
    got = reservoir_from_numpy(want, "cpu")
    assert [t.dtype for t in got] == [torch.int32, torch.float32, torch.float32, torch.int32]
    for g, w in zip(got, want):
        assert g.numpy().tobytes() == np.asarray(w).tobytes()


def test_make_tile_group_needs_a_gpu_for_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    with pytest.raises(RuntimeError, match="no GPU"):
        make_tile_group(device="cuda")


def test_bands_must_divide_the_height():
    """As the JAX package asserts, the ranks must divide the image's rows."""
    assert tiles.band_rows(32, 4) == 8
    with pytest.raises(ValueError, match="not divisible"):
        tiles.band_rows(30, 4)


def test_make_tile_group_takes_the_first_n_ranks(sharded):
    """make_tile_group(2) on 4 ranks: ranks 0 and 1 form a group of 2 (their
    bands gathered in order), ranks 2 and 3 stand outside it."""
    for rank in sharded:
        want = (rank["index"], [0.0, 1.0]) if rank["index"] < 2 else (None, None)
        assert rank["subgroup"] == want


# -- the flagship chain ---------------------------------------------------------


def test_flagship_step_matches_jax(unsharded, jax_flagship):
    """flagship_step(group=None) against the JAX flagship_step, two frames
    (frame 2 reads frame 1's spatial planes): Y bit-equal, output within
    the slice tolerance."""
    for (img, y), (ref, ref_y) in zip(unsharded, jax_flagship["single"]):
        np.testing.assert_array_equal(y, ref_y)
        _assert_slice_close(img, ref)
        assert (y >= 0).mean() > 0.5


def test_flagship_step_is_the_pt_graph_frame(cases, unsharded):
    """The port's flagship_step is its PT graph's frame bit for bit, as the
    JAX package's docstring claims of its own (parallel/flagship.py)."""
    scene, bvh, views, cfg = _port(cases["flagship"])
    frames, _ = _pt_graph_frames(scene, bvh, views, cfg, cases["flagship"]["num_lights"])
    for (img, y, _), (ref, ref_y) in zip(frames, unsharded):
        np.testing.assert_array_equal(y.astype(np.int32), ref_y)
        np.testing.assert_array_equal(img, ref)


def test_flagship_tiled_matches_unsharded(sharded, unsharded):
    """render_flagship_tiled on 4 gloo ranks, two frames, gathered, against
    the port's unsharded chain: Y bit-equal, output within 2e-5."""
    for rank in sharded:
        for (img, y), (ref, ref_y) in zip(rank["flagship"], unsharded):
            np.testing.assert_array_equal(y, ref_y)
            np.testing.assert_allclose(img, ref, atol=2e-5)


def test_flagship_tiled_matches_jax_tiled(sharded, jax_flagship):
    """The same 4-rank run against the JAX render_flagship_tiled on a
    4-device mesh: Y bit-equal, output within the slice tolerance."""
    for (img, y), (ref, ref_y) in zip(sharded[0]["flagship"], jax_flagship["tiled"]):
        np.testing.assert_array_equal(y, ref_y)
        _assert_slice_close(img, ref)


def test_flagship_tiled_gathers_two_reservoirs_a_frame(sharded):
    """The chain's only collectives: the previous spatial and the temporal
    planes gathered, 2 x 16 B a pixel of the whole image a frame."""
    for rank in sharded:
        assert rank["gathered"] == [2 * 16 * SIZE * SIZE] * FRAMES


def test_pt_graph_row_sharded_matches_one_rank(cases, sharded):
    """The PT graph with Graph.shard_image_rows over 4 ranks: each rank
    holds (SIZE / 4, SIZE, ...) image resources; gathered, its frames are
    the one-rank graph's (Y bit-equal, output within 2e-5, pt_rays summed
    equal)."""
    scene, bvh, views, cfg = _port(cases["flagship"])
    frames, shapes = _pt_graph_frames(scene, bvh, views, cfg, cases["flagship"]["num_lights"])
    band = SIZE // RANKS
    for rank in sharded:
        assert rank["graph_shapes"] == {"present_output": (band, SIZE, 3),
                                        "accumulation_image": (band, SIZE, 3),
                                        "gbuffer_position": (band, SIZE, 4)}
        for (img, y, rays), (ref, ref_y, ref_rays) in zip(rank["graph"], frames):
            np.testing.assert_array_equal(y, ref_y)
            np.testing.assert_allclose(img, ref, atol=2e-5)
            assert rays == ref_rays
    assert shapes["present_output"] == (SIZE, SIZE, 3)


# -- tiles ------------------------------------------------------------------------


def test_render_tiled_matches_path_trace_and_jax(cases, sharded):
    """render_tiled on 4 ranks, gathered: the port's full path_trace within
    2e-5 (rays summed over the ranks equal), and the JAX render_tiled on a
    4-device mesh within the slice tolerance."""
    import jax

    from rust_renderer_tpu.ops import bvh as jbvh
    from rust_renderer_tpu.parallel import make_tile_mesh, render_tiled as jax_render_tiled

    case = cases["tiles"]
    scene, bvh, views, cfg = _port(case)
    full = pathtrace.path_trace(scene, views[0], cfg, torch.zeros((SIZE, SIZE, 3)),
                                closest_hit=torch_bvh.make_closest_hit(bvh))
    for rank in sharded:
        np.testing.assert_allclose(rank["tiled"], full.output.numpy(), atol=2e-5)
        assert rank["tiled_rays"] == float(full.rays_traced)
    j = case["jax"]
    mesh = make_tile_mesh(RANKS)
    closest = jbvh.make_closest_hit(j["tree"])
    want = jax.jit(lambda s, v, a: jax_render_tiled(s, v, j["cfg"], a, mesh,
                                                    closest_hit=closest))(
        j["scene"], j["views"][0], np.zeros((SIZE, SIZE, 3), np.float32))
    _assert_slice_close(sharded[0]["tiled"], np.asarray(want.output))


def test_shard_flagship_inputs_gives_each_rank_its_rows(sharded):
    band = SIZE // RANKS
    for rank in sharded:
        rows = np.arange(rank["index"] * band, (rank["index"] + 1) * band)
        for plane in rank["shard_rows"]:
            np.testing.assert_array_equal(plane, rows)
    assert [rank["index"] for rank in sharded] == list(range(RANKS))


def test_ranks_import_neither_jax_nor_the_jax_package(sharded):
    assert not any(rank["imported_jax"] for rank in sharded)
