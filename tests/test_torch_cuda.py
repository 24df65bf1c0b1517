"""Kernels K1, K1q, K2, K3 (K3-lq and K3-multi among them), K4, K5 and the
seed kernel on the card, and the guards of their wrappers.

This file imports torch and the port only, never jax, so that it runs on a
GPU machine without jax (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tests marked `cuda` skip where torch sees no GPU. On the card, K1 must
return the plain walk's hits: t to rtol 1e-6, prim equal off exact ties,
any-hit flags equal; so must every kernel `traverse` selects under the
traversal options (K1q, K2, K3), each moving its own launch counter by one,
and K3's binary skip walk must return the plain walk's t bit for bit;
K3-multi must return K3 wide's hits bit for bit (each ray walks K3 wide's
walk), and the seed kernel its plain version's verdicts and walk
directions, bit for bit; K1's stats form its default form's hits. K1's near-first
walk is also held to the plain walk on a soup of tied triangles and on
the default scene's primary, bounce and NEE fronts. The
PT frame must match the CPU's under the tolerance of
tests/test_torch_slice.py. K4 must return its plain version's
depth bit for bit (also where a crowded tile is cut into several work
items), and K5 its triangle ids, with depth and barycentrics
within 1e-5 (both walk one table in one order); the rasterized frames must
match the CPU's under the tolerance of tests/test_torch_raster_slice.py.
The marching-cubes tree refit on the card (``ops/mc_bvh.py``) must equal
the CPU's refit of the same surface bit for bit and K1 on it the plain walk
(as above), the PT frame with the traced isosurface, captured or not, the
CPU's frame and the host loop's; the rasterized gbuffer pass (K5) its pieces on the
CPU with K5's plain version (`gbuffer.from_visibility` of a binned
rasterization): the same material ids, the planes to 1e-4 absolute plus
1e-4 relative (K5's barycentrics are within 1e-5 of the plain version's,
and positions scale them by the triangles' edges). The sanitizer's counts
in a captured loop must sum over the frames of each call, and a sanitized
PT loop stay captured and bit-equal to the host loop; a CUDA library
rebuilt from a changed source must run the new code once loaded again;
after `set_instance_transform` the next loop must capture anew, free the
old capture and stay bit-equal to the host loop. The RASTERIZED and
MINIMAL loops must be captured under torch.cuda.set_sync_debug_mode("error")
(their binning reads nothing back to the host) and each call's last frame
be a host frame bit for bit. The flagship frame on 2
gloo ranks sharing the card (``parallel/``) must match it in one process:
spatial Y bit-equal, the output within 2e-5, each rank launching K1 and
the seed kernel.
"""

import ctypes
import re

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.graph import Graph
from rust_renderer_tpu_torch.models import create_cube_scene
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.ops import (
    gbuffer, marching_cubes, mc_bvh, raster, raster_binned, traversal)
from rust_renderer_tpu_torch.renderers.passes import GBUFFER_PLANES, setup_gbuffer_pass
from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("the CUDA kernels need an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _soup_tree(device, n=3000, seed=11):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e[:, 0], base + e[:, 1]], 1).reshape(-1, 3)
    return torch_bvh.build_bvh(pos, np.arange(n * 3).reshape(-1, 3), device=device)


def _rays(device, n, seed=12):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::61] = 0.0
    t_max = rng.uniform(2.0, 20.0, n).astype(np.float32)
    t_min = np.full(n, 1e-3, np.float32)
    return [torch.tensor(x, device=device) for x in (o, d, t_min, t_max)]


def test_k1_wrapper_refuses_cpu_tensors_and_deep_trees():
    tree = _soup_tree("cpu", n=50)
    o, d, t_min, t_max = _rays("cpu", 8)
    with pytest.raises(ValueError, match="CUDA"):
        traversal.traverse_wide_cuda(tree.wnode_packed, tree.leaf_packed,
                                     tree.wide_depth, o, d, t_min, t_max, False)
    assert traversal.k1_stack_need(tree.wide_depth) <= traversal.K1_STACK_CAP
    assert traversal.k1_stack_need(16) > traversal.K1_STACK_CAP
    with pytest.raises(ValueError, match="device"):
        traversal.traverse(tree, o.to("meta"), d.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_k1_matches_plain_on_card(cuda_device, any_hit):
    tree = _soup_tree(cuda_device)
    o, d, t_min, t_max = _rays(cuda_device, 50000)
    k1 = traversal.traverse_wide_cuda(tree.wnode_packed, tree.leaf_packed,
                                      tree.wide_depth, o, d, t_min, t_max, any_hit)
    plain = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min,
                                     t_max, any_hit)
    t1, p1 = (x.cpu().numpy() for x in k1[:2])
    t2, p2 = (x.cpu().numpy() for x in plain[:2])
    np.testing.assert_array_equal(p1 >= 0, p2 >= 0)
    assert (p2 >= 0).sum() > 1000
    if not any_hit:
        hit = p2 >= 0
        np.testing.assert_allclose(t1[hit], t2[hit], rtol=1e-6)
        assert np.all((p1 == p2) | np.isclose(t1, t2, rtol=1e-6, atol=0))


def _tie_soup(device, n=2000, seed=31):
    """A soup in which every triangle appears twice (exact ties) and many
    lie in a few shared planes (near ties)."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    base[: n // 2, 2] = rng.integers(-2, 3, n // 2).astype(np.float32)  # 5 planes z = k
    e = rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32)
    e[: n // 2, :, 2] = 0.0
    tris = np.concatenate([base, base + e[:, 0], base + e[:, 1]], 1).reshape(n, 3, 3)
    pos = np.concatenate([tris, tris[::-1]]).reshape(-1, 3)
    return torch_bvh.build_bvh(pos, np.arange(len(pos)).reshape(-1, 3), device=device)


def _default_fronts(device, size=256, seed=5):
    """The default scene's primary front at size^2 and, from its hits, a
    bounce front (random directions), an NEE front (to the lights) and a
    sun front (one direction, which the seed test's rows block for most
    rays)."""
    tree, o, d, t_min, t_max = _default_scene_primary(device, size)
    t, prim = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min, t_max,
                                       False)[:2]
    hit = (prim >= 0)[:, None]
    rng = np.random.default_rng(seed)
    bounce = torch.tensor(rng.normal(size=tuple(o.shape)), dtype=torch.float32, device=device)
    bounce = torch.where(hit, bounce / bounce.norm(dim=1, keepdim=True), 0.0).contiguous()
    origin = torch.where(hit, o + t[:, None] * d - 1e-3 * d, o).contiguous()
    light = torch.tensor(rng.uniform(-4, 4, tuple(o.shape)) + [0, 6, 0], dtype=torch.float32,
                         device=device)
    to_light = light - origin
    dist = to_light.norm(dim=1)
    nee = torch.where(hit, to_light / dist[:, None], 0.0).contiguous()
    sun = torch.tensor([0.3, 0.5, -0.8], device=device)
    sun = torch.where(hit, sun / sun.norm(), 0.0).contiguous()
    return tree, {"primary": (o, d, t_min, t_max), "bounce": (origin, bounce, t_min, t_max),
                  "nee": (origin, nee, t_min, (dist * (1.0 - 1e-4)).contiguous()),
                  "sun": (origin, sun, t_min, t_max)}


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("front", ["ties", "primary", "bounce", "nee"])
def test_k1_near_first_walk_matches_plain_on_card(cuda_device, front, any_hit):
    """K1's near-first walk against the plain walk: hit flags equal; t to
    rtol 1e-6 and prim equal off ties (a tie may go to either triangle)."""
    if front == "ties":
        tree = _tie_soup(cuda_device)
        o, d, t_min, t_max = _rays(cuda_device, 50000)
    else:
        tree, fronts = _default_fronts(cuda_device)
        o, d, t_min, t_max = fronts[front]
    got = traversal.traverse_wide_cuda(tree.wnode_packed, tree.leaf_packed, tree.wide_depth,
                                       o, d, t_min, t_max, any_hit)
    want = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min, t_max,
                                    any_hit)
    t1, p1 = (x.cpu().numpy() for x in got[:2])
    t2, p2 = (x.cpu().numpy() for x in want[:2])
    np.testing.assert_array_equal(p1 >= 0, p2 >= 0)
    assert (p2 >= 0).sum() > 1000
    if not any_hit:
        hit = p2 >= 0
        np.testing.assert_allclose(t1[hit], t2[hit], rtol=1e-6)
        assert np.all((p1 == p2) | np.isclose(t1, t2, rtol=1e-6, atol=0))
        if front == "ties":
            assert (p1 != p2).sum() < hit.sum()  # ties exist and most hits agree


@pytest.mark.cuda
def test_k1_refuses_misaligned_tables(cuda_device):
    tree = _soup_tree(cuda_device, n=50)
    o, d, t_min, t_max = _rays(cuda_device, 8)
    shifted = torch.empty(tree.wnode_packed.numel() + 1, device=cuda_device)[1:].view_as(
        tree.wnode_packed)
    shifted.copy_(tree.wnode_packed)
    with pytest.raises(ValueError, match="16-byte"):
        traversal.traverse_wide_cuda(shifted, tree.leaf_packed, tree.wide_depth,
                                     o, d, t_min, t_max, False)


@pytest.mark.cuda
def test_pt_frame_on_card_matches_cpu(cuda_device):
    size, frames, bounces = 64, 2, 3

    def render(device):
        app = Application(size, size, cfg=StaticConfig(num_bounces=bounces),
                          device=device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        out = []
        for _ in range(frames):
            img = app.render_frame()["present_output"].cpu().numpy()
            out.append((img, float(app.graph.state["pt_rays"].cpu())))
        return out

    traversal.K1_LAUNCHES.clear()
    got = render(cuda_device)
    assert dict(traversal.K1_LAUNCHES) == {"closest": (1 + bounces) * frames,
                                           "any_hit": bounces * frames}
    for (img, rays), (ref, ref_rays) in zip(got, render("cpu")):
        assert rays == ref_rays
        diff = np.abs(img - ref)
        assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
        assert diff.mean() <= 1e-3


# One traverse() option set per kernel, and the counter it moves.
_KERNEL_OPTIONS = {
    "k1": (dict(), "K1_LAUNCHES"),
    "k1q": (dict(q32=True), "K1Q_LAUNCHES"),
    "k2_sd": (dict(row_cursors=0), "K2_LAUNCHES"),
    "k2_sdd": (dict(row_cursors=0, dual=True, drain_first=True), "K2_LAUNCHES"),
    "k3_binary": (dict(wide=False), "K3_LAUNCHES"),
    "k3_binary_ordered": (dict(wide=False, ordered=True), "K3_LAUNCHES"),
    "k3_wide": (dict(row_cursors=0, steady_drain=0), "K3_LAUNCHES"),
    "k3_wide_ordered": (dict(row_cursors=0, steady_drain=0, ordered=True), "K3_LAUNCHES"),
    "k3_wide_dual": (dict(row_cursors=0, steady_drain=0, dual=True), "K3_LAUNCHES"),
    "k3_wide_lq": (dict(row_cursors=0, steady_drain=0, leaf_queue=4), "K3_LAUNCHES"),
    "k3_wide_multi": (dict(row_cursors=0, multi=4), "K3_LAUNCHES"),
}


def test_kernel_options_cover_every_kernel():
    tree = _soup_tree("cpu", n=50)
    for kernel, (options, _) in _KERNEL_OPTIONS.items():
        rule = {k: v for k, v in options.items() if k != "drain_first"}
        assert traversal.select_kernel(tree, **rule) == kernel
    assert set(_KERNEL_OPTIONS) == set(traversal.KERNELS)


def test_traversal_wrappers_refuse_cpu_tensors():
    tree = _soup_tree("cpu", n=50)
    o, d, t_min, t_max = _rays("cpu", 8)
    rays = (o, d, t_min, t_max, False)
    calls = {
        "K1q": lambda: traversal.traverse_q32_cuda(
            tree.wnode_q32, tree.wnode_meta32, tree.q32_leaf_perm, tree.leaf_packed,
            tree.q32_depth, *rays),
        "K2": lambda: traversal.traverse_drain_cuda(
            tree.wnode_packed, tree.leaf_packed, tree.wide_depth, *rays),
        "K3": lambda: traversal.traverse_binary_cuda(
            tree.node_packed, tree.leaf_packed, tree.max_depth, *rays),
        "K3 wide": lambda: traversal.traverse_wide_k3_cuda(
            tree.wnode_packed, tree.leaf_packed, tree.wide_depth, *rays, ordered=True),
    }
    for name, call in calls.items():
        with pytest.raises(ValueError, match="CUDA"):
            call()


@pytest.mark.cuda
def test_traversal_wrappers_refuse_wrong_tables(cuda_device):
    tree = _soup_tree(cuda_device, n=200)
    o, d, t_min, t_max = _rays(cuda_device, 64)
    rays = (o, d, t_min, t_max, False)
    with pytest.raises(ValueError, match="wnode_q32"):
        traversal.traverse_q32_cuda(tree.wnode_q32[:, :64].contiguous(), tree.wnode_meta32,
                                    tree.q32_leaf_perm, tree.leaf_packed, tree.q32_depth,
                                    *rays)
    with pytest.raises(ValueError, match="wnode_meta32"):
        traversal.traverse_q32_cuda(tree.wnode_q32, tree.wnode_meta32[1:], tree.q32_leaf_perm,
                                    tree.leaf_packed, tree.q32_depth, *rays)
    with pytest.raises(ValueError, match="stack entries"):
        traversal.traverse_q32_cuda(tree.wnode_q32, tree.wnode_meta32, tree.q32_leaf_perm,
                                    tree.leaf_packed, traversal.K1Q_STACK_CAP, *rays)
    with pytest.raises(ValueError, match="wnode_packed"):
        traversal.traverse_drain_cuda(tree.wnode_packed[:, :96].contiguous(),
                                      tree.leaf_packed, tree.wide_depth, *rays)
    with pytest.raises(ValueError, match="leaf_packed"):
        traversal.traverse_drain_cuda(tree.wnode_packed, tree.leaf_packed.view(-1, 60),
                                      tree.wide_depth, *rays)
    with pytest.raises(ValueError, match="node_packed"):
        traversal.traverse_binary_cuda(tree.node_packed[:, :6].contiguous(),
                                       tree.leaf_packed, tree.max_depth, *rays)
    with pytest.raises(ValueError, match="stack entries"):
        traversal.traverse_binary_cuda(tree.node_packed, tree.leaf_packed,
                                       traversal.K3B_STACK_CAP, *rays, ordered=True)
    with pytest.raises(ValueError, match="stack"):
        traversal.traverse_wide_k3_cuda(tree.wnode_packed, tree.leaf_packed, 16, *rays,
                                        dual=True)
    with pytest.raises(ValueError, match="t_max"):
        traversal.traverse_drain_cuda(tree.wnode_packed, tree.leaf_packed, tree.wide_depth,
                                      o, d, t_min, t_max[:32], False)


def _default_scene_primary(device, size=256):
    """The default scene's BVH on `device` and its camera front at size^2."""
    from rust_renderer_tpu_torch.ops import pathtrace, rays

    app = Application(size, size, device=device)
    app.create_scene()
    view = app.view.with_camera(app.camera, size, size).to(app.device)
    py, px = pathtrace.pixel_grid(size, size, app.device)
    o, d = rays.generate_camera_rays(view.inverse_view, view.inverse_projection,
                                     px.float() + 0.5, py.float() + 0.5, size, size)
    n = size * size
    return (app.scene_bvh, o.reshape(n, 3).contiguous(), d.reshape(n, 3).contiguous(),
            torch.full((n,), 1e-3, device=app.device), torch.full((n,), 1e4, device=app.device))


@pytest.mark.cuda
@pytest.mark.parametrize("front", ["soup", "default_primary"])
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("kernel", sorted(_KERNEL_OPTIONS))
def test_traversal_kernel_matches_plain_on_card(cuda_device, kernel, any_hit, front):
    if front == "soup":
        tree = _soup_tree(cuda_device)
        o, d, t_min, t_max = _rays(cuda_device, 50000)
    else:
        tree, o, d, t_min, t_max = _default_scene_primary(cuda_device)
    options, counter_name = _KERNEL_OPTIONS[kernel]
    counter = getattr(traversal, counter_name)
    before = sum(counter.values())
    got = traversal.traverse(tree, o, d, t_min, t_max, any_hit=any_hit, **options)
    torch.cuda.synchronize()
    assert sum(counter.values()) == before + 1
    want = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min, t_max,
                                    any_hit)
    t1, p1 = (x.cpu().numpy() for x in got[:2])
    t2, p2 = (x.cpu().numpy() for x in want[:2])
    np.testing.assert_array_equal(p1 >= 0, p2 >= 0)
    assert (p2 >= 0).sum() > 1000
    if not any_hit:
        hit = p2 >= 0
        np.testing.assert_allclose(t1[hit], t2[hit], rtol=1e-6)
        assert np.all((p1 == p2) | np.isclose(t1, t2, rtol=1e-6, atol=0))
        if kernel == "k3_binary":
            np.testing.assert_array_equal(t1.view(np.int32), t2.view(np.int32))
            np.testing.assert_array_equal(p1, p2)


@pytest.mark.cuda
def test_k2_takes_a_tree_k1_refuses(cuda_device):
    """Nested shells (tests/test_torch_traversal_variants.py::_nested) give a
    wide tree deeper than K1's stack; the hit queries' defaults send it to
    K2, which matches the plain walk."""
    rng = np.random.default_rng(0)
    tris = []
    for k in range(20):
        s = 1e4 * 0.3 ** k
        c = np.stack([rng.uniform(s / 2, s, 200), rng.uniform(0, s, 200),
                      rng.uniform(0, s, 200)], 1)
        e = rng.normal(0.0, s / 20, (200, 2, 3))
        tris.append(np.stack([c, c + e[:, 0], c + e[:, 1]], 1))
    pos = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    tree = torch_bvh.build_bvh(pos, np.arange(len(pos)).reshape(-1, 3), device=cuda_device)
    assert tree.wide_depth > 14
    n = 50000
    s = 1e4 * 0.3 ** rng.integers(0, 17, n)
    o = s[:, None] * rng.uniform(-0.5, 1.5, (n, 3))
    target = s[:, None] * np.stack([rng.uniform(0.5, 1, n), rng.uniform(0, 1, n),
                                    rng.uniform(0, 1, n)], 1)
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    o, d, t_min, t_max = (torch.tensor(x, dtype=torch.float32, device=cuda_device)
                          for x in (o, d, 1e-6 * s, 4 * s))
    for any_hit in (False, True):
        options = dict(row_cursors=8, steady_drain=3, dual=True)
        assert traversal.select_kernel(tree, any_hit, **options) == "k2_sdd"
        got = traversal.traverse(tree, o, d, t_min, t_max, any_hit=any_hit,
                                 drain_first=any_hit, **options)
        want = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min,
                                        t_max, any_hit)
        p1, p2 = got[1].cpu().numpy(), want[1].cpu().numpy()
        np.testing.assert_array_equal(p1 >= 0, p2 >= 0)
        assert (p2 >= 0).sum() > 5000
        if not any_hit:
            hit = p2 >= 0
            np.testing.assert_allclose(got[0].cpu().numpy()[hit], want[0].cpu().numpy()[hit],
                                       rtol=1e-6)


@pytest.mark.cuda
def test_traversal_stats_count_the_walk(cuda_device):
    """K3's stats count the slab tests of non-empty child slots and the
    tests of non-empty leaf slots; K2's peak queue depth keeps to its cap,
    and a one-row queue (every push tests the newest row first) still
    matches the plain walk."""
    tree, o, d, t_min, t_max = _default_scene_primary(cuda_device)
    st = traversal.traverse(tree, o, d, t_min, t_max, row_cursors=0, steady_drain=0,
                            stats=True)[4]
    assert tuple(st.shape) == (4, o.shape[0])
    pops, leaf_pops, boxes, tris = st.long()
    nodes = pops - leaf_pops
    assert bool((boxes >= nodes).all()) and bool((boxes <= traversal.K1_WIDTH * nodes).all())
    assert bool((tris >= leaf_pops).all())
    assert bool((tris <= traversal.K1_LEAF_SLOTS * leaf_pops).all())
    assert int(boxes.sum()) < traversal.K1_WIDTH * int(nodes.sum())
    want = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min, t_max,
                                    False)
    hit = want[1] >= 0
    for cap in (1, traversal.K2_QUEUE_CAP):
        got = traversal.traverse_drain_cuda(tree.wnode_packed, tree.leaf_packed,
                                            tree.wide_depth, o, d, t_min, t_max, False,
                                            stats=True, queue_cap=cap)
        assert int(got[4][2].max()) <= cap
        assert torch.equal(got[1] >= 0, hit)
        torch.testing.assert_close(got[0][hit], want[0][hit], rtol=1e-6, atol=0)
        assert bool(((got[1] == want[1]) | torch.isclose(got[0], want[0], rtol=1e-6,
                                                         atol=0)).all())


def test_lq_multi_and_seed_wrappers_refuse_cpu_tensors_and_bad_options():
    tree = _soup_tree("cpu", n=50)
    o, d, t_min, t_max = _rays("cpu", 8)
    rays = (o, d, t_min, t_max, False)
    tris = torch_bvh.seed_table(tree, 4)
    for call in (
            lambda: traversal.traverse_lq_cuda(tree.wnode_packed, tree.leaf_packed,
                                               tree.wide_depth, *rays, flush_k=4),
            lambda: traversal.traverse_multi_cuda(tree.wnode_packed, tree.leaf_packed,
                                                  tree.wide_depth, *rays, m=4),
            lambda: torch_bvh.seed_occlusion_cuda(tris, o, d, t_min, t_max)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert traversal.lq_queue_need(49) == traversal.LQ_QUEUE_CAP
    assert traversal.multi_rays((64, 64), 8) == 4  # 4 blocks: 8 halves to 4
    assert traversal.multi_rays((1080, 1920), 8) == 8  # padded flat front


@pytest.mark.cuda
def test_lq_and_multi_refuse_what_they_cannot_take(cuda_device):
    tree = _soup_tree(cuda_device, n=200)
    o, d, t_min, t_max = _rays(cuda_device, 64)
    wide = (tree.wnode_packed, tree.leaf_packed)
    with pytest.raises(ValueError, match="leaf queue"):
        traversal.traverse_lq_cuda(*wide, tree.wide_depth, o, d, t_min, t_max, False,
                                   flush_k=50)
    with pytest.raises(ValueError, match="at least one"):
        traversal.traverse_lq_cuda(*wide, tree.wide_depth, o, d, t_min, t_max, False,
                                   flush_k=0)
    with pytest.raises(ValueError, match="stack"):
        traversal.traverse_lq_cuda(*wide, 33, o, d, t_min, t_max, False, flush_k=4)
    with pytest.raises(ValueError, match="rays per thread"):
        traversal.traverse_multi_cuda(*wide, tree.wide_depth, o, d, t_min, t_max, False, m=3)
    with pytest.raises(ValueError, match="stack"):
        traversal.traverse_multi_cuda(*wide, 32, o, d, t_min, t_max, False, m=2)


@pytest.mark.cuda
@pytest.mark.parametrize("front", ["soup", "default_primary"])
@pytest.mark.parametrize("any_hit", [False, True])
def test_lq_flush_sweep_on_card(cuda_device, any_hit, front):
    """K3-lq at the JAX tests' flush sizes (1, 4, 8) and the largest its
    queue takes; stats count the walk."""
    if front == "soup":
        tree = _soup_tree(cuda_device)
        o, d, t_min, t_max = _rays(cuda_device, 50000)
    else:
        tree, o, d, t_min, t_max = _default_scene_primary(cuda_device)
    want = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min, t_max,
                                    any_hit)
    hit = want[1] >= 0
    for k in (1, 4, 8, traversal.LQ_QUEUE_CAP + 1 - traversal.K1_WIDTH):
        before = traversal.K3_LAUNCHES["wide_lq"]
        got = traversal.traverse(tree, o, d, t_min, t_max, any_hit=any_hit, row_cursors=0,
                                 steady_drain=0, leaf_queue=k, stats=True)
        assert traversal.K3_LAUNCHES["wide_lq"] == before + 1
        assert torch.equal(got[1] >= 0, hit)
        pops, leaf_pops, boxes, tris = got[4].long()
        assert bool((boxes <= traversal.K1_WIDTH * pops).all())
        assert bool((tris <= traversal.K1_LEAF_SLOTS * leaf_pops).all())
        if not any_hit:
            torch.testing.assert_close(got[0][hit], want[0][hit], rtol=1e-6, atol=0)
            assert bool(((got[1] == want[1]) | torch.isclose(got[0], want[0], rtol=1e-6,
                                                             atol=0)).all())


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_multi_walks_k3_wide_bit_for_bit(cuda_device, any_hit):
    tree, o, d, t_min, t_max = _default_scene_primary(cuda_device)
    want = traversal.traverse(tree, o, d, t_min, t_max, any_hit=any_hit, row_cursors=0,
                              steady_drain=0)
    for m in traversal.MULTI_WIDTHS:
        # A ray count that leaves the last thread's rays short.
        got = traversal.traverse_multi_cuda(tree.wnode_packed, tree.leaf_packed,
                                            tree.wide_depth, o[:-3], d[:-3], t_min[:-3],
                                            t_max[:-3], any_hit, m)
        assert torch.equal(got[0].view(torch.int32), want[0][:-3].view(torch.int32))
        assert torch.equal(got[1], want[1][:-3])


@pytest.mark.cuda
@pytest.mark.parametrize("front", ["soup", "default_primary", "default_nee", "default_sun"])
def test_seed_kernel_matches_plain_on_card(cuda_device, front):
    """The seed kernel's verdicts and walk directions equal its plain
    version's (bit for bit), and every verdict is a true occlusion; on the
    NEE front toward the lights the rows block no ray."""
    if front == "soup":
        tree = _soup_tree(cuda_device)
        o, d, t_min, t_max = _rays(cuda_device, 50000)
    elif front == "default_primary":
        tree, o, d, t_min, t_max = _default_scene_primary(cuda_device)
    else:
        tree, fronts = _default_fronts(cuda_device)
        o, d, t_min, t_max = fronts[front[len("default_"):]]
    tris = torch_bvh.seed_table(tree, 4)
    before = torch_bvh.SEED_LAUNCHES
    got, walk_d = torch_bvh.seed_occlusion_cuda(tris, o, d, t_min, t_max)
    assert torch_bvh.SEED_LAUNCHES == before + 1
    want, want_d = torch_bvh.seed_occlusion_plain(tris, o, d, t_min, t_max)
    assert torch.equal(got, want)
    assert torch.equal(walk_d.view(torch.int32), want_d.view(torch.int32))
    occluded = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min,
                                        t_max, True)[1] >= 0
    assert not bool((got & ~occluded).any())
    assert (int(got.sum()) == 0) == (front == "default_nee")


@pytest.mark.cuda
def test_seed_kernel_takes_every_table_size(cuda_device):
    """Tables of 1 to 250 triangles (the leaf table's first live
    triangles), within one launch's SEED_LAUNCH_TRIS and across several,
    rays finishing at every step: verdicts and walk directions equal the
    plain version's; a table on the card or with no triangle is
    refused."""
    tree = _soup_tree(cuda_device)
    o, d, t_min, t_max = _rays(cuda_device, 20000)
    lp = tree.leaf_packed.cpu().numpy()
    slots = np.nonzero(lp[:, 108:].view(np.int32) >= 0)
    geo = lp[:, :108].reshape(-1, 12, 9)[slots][:250]
    full = torch.from_numpy(np.ascontiguousarray(geo.T))
    assert full.shape == (9, 250)
    per = torch_bvh.SEED_LAUNCH_TRIS
    for n in (1, 2, 31, 33, 48, per - 1, per, per + 1, 2 * per, 2 * per + 1, 250):
        tris = full[:, :n].contiguous()
        got = torch_bvh.seed_occlusion_cuda(tris, o, d, t_min, t_max)
        want = torch_bvh.seed_occlusion_plain(tris, o, d, t_min, t_max)
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1].view(torch.int32), want[1].view(torch.int32))
    assert int(want[0].sum()) > int(torch_bvh.seed_occlusion_plain(
        full[:, :per].contiguous(), o, d, t_min, t_max)[0].sum())
    with pytest.raises(ValueError, match="at least one"):
        torch_bvh.seed_occlusion_cuda(full[:, :0].contiguous(), o, d, t_min, t_max)
    with pytest.raises(ValueError, match="seed table"):
        torch_bvh.seed_occlusion_cuda(full.to(cuda_device), o, d, t_min, t_max)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [12, 40])
@pytest.mark.parametrize("front", ["primary", "nee"])
def test_seed_test_reaches_any_k_on_card(cuda_device, front, k):
    """`make_seed_test` at 12 and 40 rows on the default scene's fronts (96
    and several launches' worth of triangles): the card's verdicts and
    walk directions are the plain version's, in one launch count."""
    tree, fronts = _default_fronts(cuda_device)
    o, d, t_min, t_max = fronts[front]
    tris = torch_bvh.seed_table(tree, k)
    assert tris.shape[1] >= torch_bvh.SEED_LAUNCH_TRIS
    before = torch_bvh.SEED_LAUNCHES
    got, walk_d = torch_bvh.make_seed_test(tree, k)(o, d, t_min, t_max)
    assert torch_bvh.SEED_LAUNCHES == before + 1
    want, want_d = torch_bvh.seed_occlusion_plain(tris, o, d, t_min, t_max)
    assert torch.equal(got, want)
    assert torch.equal(walk_d.view(torch.int32), want_d.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
@pytest.mark.parametrize("front", ["primary", "bounce", "nee"])
def test_k1_phase_stats_count_its_walk(cuda_device, front, any_hit):
    """K1's stats form returns the default form's hits bit for bit and
    counts its own walk: per ray, iterations = entries expanded + pops
    culled, slab tests between one and 16 per entry expanded, triangle
    tests at most 12 per leaf row tested; for closest hits, no more
    triangle tests than K3 wide's walk of the same front, which tests
    every leaf it pops, without K1's near-first order and re-check."""
    tree, fronts = _default_fronts(cuda_device)
    o, d, t_min, t_max = fronts[front]
    want = traversal.traverse(tree, o, d, t_min, t_max, any_hit=any_hit)
    before = traversal.K1_LAUNCHES["any_hit" if any_hit else "closest"]
    got = traversal.traverse(tree, o, d, t_min, t_max, any_hit=any_hit, phase_stats=True)
    assert traversal.K1_LAUNCHES["any_hit" if any_hit else "closest"] == before + 1
    for a, b in zip(got[:4], want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert tuple(got[4].shape) == (6, o.shape[0])
    iters, expanded, leaves, culled, boxes, tris = got[4].long()
    assert torch.equal(iters, expanded + culled)
    assert bool((boxes >= expanded).all()) and bool((boxes <= 16 * expanded).all())
    assert bool((tris <= 12 * leaves).all()) and bool((tris >= leaves).all())
    if any_hit:
        assert int(culled.sum()) == 0
    live = (d * d).sum(dim=1) > 0
    assert bool((iters[live] >= 1).all()) and int(iters[~live].sum()) == 0
    if not any_hit:
        k3 = traversal.traverse(tree, o, d, t_min, t_max, row_cursors=0, steady_drain=0,
                                stats=True)[4].long()
        assert int(tris.sum()) <= int(k3[3].sum())
    assert traversal.traverse(tree, o, d, t_min, t_max, overflow_stats=True)[4] is None
    assert traversal.traverse(tree, o, d, t_min, t_max, row_cursors=0, phase_stats=True)[4] \
        is None


def _raster_soup(device, n=20000, width=1920, height=1080, seed=21):
    """A soup of small triangles plus one screen-wide triangle (the global
    list), perspective-projected: (clip, indices) on `device`."""
    rng = np.random.default_rng(seed)
    tris = rng.uniform(-1.3, 1.3, (n, 1, 3)) + rng.normal(0, 0.03, (n, 3, 3))
    tris = np.concatenate([tris, [[[-9.0, -9.0, 0.4], [9.0, -9.0, 0.4], [0.0, 9.0, 0.4]]]])
    v = tris.reshape(-1, 3).astype(np.float32)
    z = v[:, 2] + 3.0
    clip = np.stack([v[:, 0], v[:, 1] * width / height, 0.55 * z - 0.1, z], -1)
    clip = torch.tensor(clip, dtype=torch.float32, device=device)
    idx = torch.arange(3 * (n + 1), dtype=torch.int32, device=device).reshape(-1, 3)
    return clip, idx


def _raster_bins(device, vis, n=20000, width=1920, height=1080, seed=21):
    """`_raster_soup` binned on `device` by the plain version."""
    clip, idx = _raster_soup(device, n, width, height, seed)
    rows = raster_binned.tri_rows(clip, idx, width, height, vis=vis)
    return raster_binned.bin_triangles(rows, width, height), width, height


def _assert_bins_equal(got, want):
    """Every field of two Bins equal, the table bit for bit."""
    assert (got.g_base, got.nx, got.ny) == (want.g_base, want.nx, want.ny)
    assert got.table.shape == want.table.shape
    assert torch.equal(got.table.view(torch.int32), want.table.view(torch.int32))
    for name in ("starts", "counts", "g_count", "row_tile"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and torch.equal(a, b), name
    for a, b in zip(got.row_box, want.row_box, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_binning_library_declaration_matches_its_source():
    """`raster_bin` of csrc/raster_bin.cu, as the module declares it: its
    parameters' kinds in order (pointers, the four ints by name, the stream
    last), the compile-time sizes the module's, and every kernel of the
    file launched once by it (`BIN_KERNELS`), which returns
    cudaGetLastError."""
    (source,) = raster_binned.BIN.sources
    with open(source, encoding="utf-8") as f:
        src = f.read()
    launch = src[src.index('extern "C" int raster_bin('):]
    params = [p.strip() for p in launch[launch.index("(") + 1:launch.index(")")].split(",")]
    assert params[-1] == "void* stream"
    kinds = [ctypes.c_void_p if "*" in p else ctypes.c_int for p in params]
    assert kinds == raster_binned.BIN.functions["raster_bin"]
    assert [p.split()[-1] for p in params if "*" not in p] == [
        "t_count", "width", "height", "stride"]
    for name, value in (("BIN_CHUNK", raster_binned.BIN_CHUNK),
                        ("BIN_MAX_TILES", raster_binned.BIN_MAX_TILES),
                        ("BIN_TILE_W", raster_binned.TILE_W), ("BIN_TILE_H", raster_binned.TILE_H),
                        ("BIN_SPAN_X", raster_binned.SPAN_X), ("BIN_SPAN_Y", raster_binned.SPAN_Y)):
        assert re.search(rf"#define {name} {value}\b", src), name
    launch = launch[:launch.index("\n}")]
    kernels = re.findall(r"__global__ void __launch_bounds__\(\w+\)\s*(\w+)\(", src)
    assert len(kernels) == raster_binned.BIN_KERNELS
    assert all(launch.count(f"{k}<<<") == 1 for k in kernels)
    assert launch.rstrip().endswith("return static_cast<int>(cudaGetLastError());")


@pytest.mark.parametrize("wrong", ["float64_clip", "clip_of_3", "int64_indices", "strided_clip",
                                   "indices_elsewhere", "no_triangles", "too_many_tiles",
                                   "cpu_tensors"])
def test_binning_library_refuses_what_it_cannot_take(wrong, monkeypatch):
    """An input of another type, shape, layout or device, an empty call, a
    grid of more tiles than its counters take, or CPU tensors raise before
    the library is built or launched."""
    monkeypatch.setattr(raster_binned.BIN, "library", lambda: pytest.fail("library built"))
    clip, idx = _raster_soup("cpu", n=50, width=300, height=70)
    width, height, match = 300, 70, {
        "float64_clip": "dtype", "clip_of_3": "shape", "int64_indices": "dtype",
        "strided_clip": "contiguous", "indices_elsewhere": "is on meta",
        "no_triangles": "nothing to bin", "too_many_tiles": "tiles",
        "cpu_tensors": "CUDA tensors"}[wrong]
    if wrong == "float64_clip":
        clip = clip.double()
    elif wrong == "clip_of_3":
        clip = clip[:, :3].contiguous()
    elif wrong == "int64_indices":
        idx = idx.long()
    elif wrong == "strided_clip":
        clip = torch.cat([clip, clip], 1)[:, ::2]
    elif wrong == "indices_elsewhere":
        idx = idx.to("meta")
    elif wrong == "no_triangles":
        idx = idx[:0]
    elif wrong == "too_many_tiles":
        width, height = raster_binned.TILE_W * 300, raster_binned.TILE_H * 200
    before = raster_binned.BIN_LAUNCHES
    with pytest.raises(ValueError, match=match):
        raster_binned.bins_cuda(clip, idx, width, height)
    assert raster_binned.BIN_LAUNCHES == before


@pytest.mark.parametrize("vis", [False, True])
def test_cpu_tensors_take_the_plain_binning(vis, monkeypatch):
    """On CPU tensors `binned_rows`, and the rasterizers through it, run
    `tri_rows` and `bin_triangles`: the library is never built and its
    counter stays where it was."""
    monkeypatch.setattr(raster_binned.BIN, "library", lambda: pytest.fail("library built"))
    before = raster_binned.BIN_LAUNCHES
    w, h = 300, 70
    clip, idx = _raster_soup("cpu", n=200, width=w, height=h)
    want = raster_binned.bin_triangles(raster_binned.tri_rows(clip, idx, w, h, vis), w, h)
    _assert_bins_equal(raster_binned.binned_rows(clip, idx, w, h, vis), want)
    if vis:
        got = raster_binned.rasterize_binned(clip, idx, w, h)
        assert torch.equal(got.tri, raster_binned.vis_binned_plain(want, w, h).tri)
    else:
        got = raster_binned.rasterize_depth_binned(clip, idx, w, h)
        assert torch.equal(got, raster_binned.depth_binned_plain(want, w, h))
    assert raster_binned.BIN_LAUNCHES == before


def test_other_devices_have_no_binning():
    clip, idx = _raster_soup("cpu", n=10, width=300, height=70)
    with pytest.raises(ValueError, match="no binning"):
        raster_binned.binned_rows(clip.to("meta"), idx.to("meta"), 300, 70)


def _binning_cases(device, width: int, height: int, seed: int = 41):
    """(clip, indices) on `device`: a soup of small perspective triangles
    whose depths cross the near plane (pieces clipped to one and to two,
    and triangles behind the camera, in bulk), and one or more of each
    case the binning decides: spans of 1 x 1, 2 x 1, 1 x 4 and 2 x 4 tiles
    (binned) and of one more tile either way (global), a screen-wide
    triangle, triangles in the last, partial column and row of tiles,
    across the image's edges, off it on each side, degenerate (collinear,
    one point), clipped by the near plane to one and to two pieces, behind
    the camera (clip z and w below 0) and with w below 0 alone."""
    tw, th = raster_binned.TILE_W, raster_binned.TILE_H

    def screen(pts, z=0.5):
        x, y = np.asarray(pts, np.float64).T
        return np.stack([2 * x / width - 1, 1 - 2 * y / height, np.full(3, z), np.ones(3)], -1)

    cases = [
        screen([(10, 3), (2 * tw - 12, 3), (10, 4 * th - 3)]),
        screen([(tw + 5, th + 2), (tw + 30, th + 2), (tw + 5, th + 20)]),
        screen([(tw - 20, 5), (tw + 20, 5), (tw, 25)]),
        screen([(40, 2), (60, 4 * th - 2), (30, 60)]),
        screen([(10, 3), (2 * tw + 12, 3), (10, 40)]),
        screen([(10, 3), (40, 3), (10, 4 * th + 5)]),
        screen([(-50, -50), (3 * width, -40), (-40, 3 * height)], z=0.9),
        screen([(width - 3, height - 2), (width - 1, height - 30), (width - 40, height - 1)]),
        screen([(-30, 10), (20, 15), (-10, 40)]),
        screen([(width - 10, -20), (width + 30, 10), (width - 5, 12)]),
        screen([(-50, 10), (-5, 20), (-30, 30)]),
        screen([(width + 1, 10), (width + 50, 20), (width + 5, 30)]),
        screen([(100, -40), (140, -2), (120, -30)]),
        screen([(100, height + 1), (140, height + 40), (120, height + 5)]),
        screen([(100, 50), (150, 60), (200, 70)]),
        screen([(100, 50), (100, 50), (100, 50)]),
        [[-0.5, -0.5, -0.2, 0.3], [0.5, -0.4, 0.6, 1.0], [0.0, 0.5, 0.4, 0.8]],
        [[-0.5, -0.5, -0.2, 0.3], [0.5, -0.4, -0.1, 0.4], [0.0, 0.5, 0.4, 0.8]],
        [[-0.5, -0.5, -0.2, -0.3], [0.5, -0.4, -0.1, -0.4], [0.0, 0.5, -0.4, -0.8]],
        [[-0.5, -0.5, 0.2, -0.3], [0.5, -0.4, 0.1, -0.4], [0.0, 0.5, 0.4, -0.8]],
    ]
    rng = np.random.default_rng(seed)
    n, n_near = 3000, 600
    c = rng.uniform(-1.3, 1.3, (n, 1, 3)) + rng.normal(0, 0.05, (n, 3, 3))
    near = (rng.uniform([-0.15, -0.15, 0.12], [0.15, 0.15, 0.26], (n_near, 1, 3))
            + rng.normal(0, [0.01, 0.01, 0.03], (n_near, 3, 3)))
    c = np.concatenate([c + [0.0, 0.0, 1.0], near])  # view depth; the near plane at 0.18
    soup = np.stack([c[..., 0], c[..., 1] * width / height, 0.55 * c[..., 2] - 0.1, c[..., 2]],
                    -1)
    tris = np.concatenate([np.asarray(cases), soup]).astype(np.float32)
    clip = torch.tensor(tris.reshape(-1, 4), device=device)
    idx = torch.arange(clip.shape[0], dtype=torch.int32, device=device).reshape(-1, 3)
    return clip, idx


@pytest.mark.cuda
@pytest.mark.parametrize("vis", [False, True])
@pytest.mark.parametrize("size", [(1024, 256), (1000, 270)])
def test_binning_library_matches_plain_on_card(cuda_device, size, vis):
    """The library's Bins equal `tri_rows` + `bin_triangles` on the card in
    every field, bit for bit, on `_binning_cases` (an image a whole number
    of tiles, and one that is not), for depth rows and visibility rows; a
    call moves its counter by its launches, and `binned_rows` on CUDA
    tensors goes through it."""
    width, height = size
    clip, idx = _binning_cases(cuda_device, width, height)
    tr = raster_binned.tri_rows(clip, idx, width, height, vis=vis)
    want = raster_binned.bin_triangles(tr, width, height)
    t = idx.shape[0]
    assert int(tr.valid[t:].sum()) > 20  # second pieces of the near clip
    assert int((tr.valid & ~tr.is_global & (tr.span_w == 2) & (tr.span_h == 4)).sum()) >= 1
    assert int(want.g_count) >= 4 and int(want.counts[-1]) >= 1
    before = raster_binned.BIN_LAUNCHES
    got = raster_binned.bins_cuda(clip, idx, width, height, vis)
    assert raster_binned.BIN_LAUNCHES == before + raster_binned.BIN_KERNELS
    _assert_bins_equal(got, want)
    _assert_bins_equal(raster_binned.binned_rows(clip, idx, width, height, vis), want)
    assert raster_binned.BIN_LAUNCHES == before + 2 * raster_binned.BIN_KERNELS


@pytest.mark.cuda
def test_binning_library_on_the_sponza_cascades_on_card(cuda_device):
    """The Sponza-scale scene's four 4096² cascades (259,932 triangles) at
    the default camera and sun: the library's Bins are the plain version's
    bit for bit, and so is K4's depth over them."""
    from rust_renderer_tpu_torch.camera import Camera
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.ops import shadow
    from rust_renderer_tpu_torch.renderer import Renderer

    cam = Camera([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0], fov_degrees=60.0,
                 aspect_ratio=1920 / 1080, z_near=0.01, z_far=1000.0)
    scene = Renderer()
    create_sponza_scale_scene(scene, cam)
    packed = scene.pack_numpy()
    positions = torch.tensor(packed["positions"], device=cuda_device)
    indices = torch.tensor(packed["indices"], device=cuda_device)
    mats, _ = shadow.cascade_matrices(cam.get_view(), cam.get_projection(),
                                      cam.get_near_plane(), cam.get_far_plane(),
                                      np.array([0.0, 0.90631, 0.42262], np.float32))
    size = 4096
    for m in torch.tensor(mats, device=cuda_device):
        clip = raster.transform_vertices(positions, m)
        want = raster_binned.bin_triangles(raster_binned.tri_rows(clip, indices, size, size),
                                           size, size)
        got = raster_binned.bins_cuda(clip, indices, size, size)
        assert int(want.counts.sum()) > 200000
        _assert_bins_equal(got, want)
        depth = raster_binned.depth_binned_cuda(got, size, size)
        assert torch.equal(depth, raster_binned.depth_binned_cuda(want, size, size))
        assert int((depth < 1.0).sum()) > 0


def test_k45_wrappers_refuse_cpu_tensors_and_oversized_grids():
    bins, w, h = _raster_bins("cpu", vis=False, n=50, width=300, height=70)
    with pytest.raises(ValueError, match="CUDA"):
        raster_binned.depth_binned_cuda(bins, w, h)
    with pytest.raises(ValueError, match="another image size"):
        raster_binned.depth_binned_cuda(bins, w + 256, h)
    tall = 65536
    # K4's and K5's grids are persistent: their limit is the int32 numbering
    # of their items, checked against the table's static capacity (2^25
    # global slots here: a table that wide, as a view of one row), not
    # against the live global count, which stays on the device.
    def wide(b):
        return b._replace(ny=tall, table=b.table[:1].expand(b.g_base + (1 << 25), -1))

    with pytest.raises(ValueError, match="work items"):
        raster_binned.depth_binned_cuda(wide(bins), w, tall * 32)
    vis_bins, _, _ = _raster_bins("cpu", vis=True, n=50, width=300, height=70)
    with pytest.raises(ValueError, match="work items"):
        raster_binned.vis_binned_cuda(wide(vis_bins), w, tall * 32)
    with pytest.raises(ValueError, match="rows of 28"):
        raster_binned.vis_binned_cuda(bins, w, h)
    with pytest.raises(ValueError, match="CUDA"):
        raster_binned.vis_binned_cuda(vis_bins, w, h)


@pytest.mark.cuda
def test_k4_matches_plain_on_card(cuda_device):
    bins, w, h = _raster_bins(cuda_device, vis=False)
    assert bins.g_count.device.type == "cuda" and int(bins.g_count) >= 1
    got = raster_binned.depth_binned_cuda(bins, w, h)
    want = raster_binned.depth_binned_plain(bins, w, h)
    assert (want < 1.0).float().mean() > 0.5
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_k4_is_exact_on_the_sponza_cascades_on_card(cuda_device):
    """The four 4096² cascades of the Sponza-scale scene (259,932
    triangles) at the default camera and sun: K4's depth is its plain
    version's bit for bit, covers the texels the float64 interpolation at
    its own coverage covers, and lies within 1e-5 of it on each (the JAX
    kernels' formula was off by up to 0.03 there)."""
    from rust_renderer_tpu_torch.camera import Camera
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.ops import raster, shadow
    from rust_renderer_tpu_torch.renderer import Renderer

    cam = Camera([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0], fov_degrees=60.0,
                 aspect_ratio=1920 / 1080, z_near=0.01, z_far=1000.0)
    scene = Renderer()
    create_sponza_scale_scene(scene, cam)
    packed = scene.pack_numpy()
    positions = torch.tensor(packed["positions"], device=cuda_device)
    indices = torch.tensor(packed["indices"], device=cuda_device)
    mats, _ = shadow.cascade_matrices(cam.get_view(), cam.get_projection(),
                                      cam.get_near_plane(), cam.get_far_plane(),
                                      np.array([0.0, 0.90631, 0.42262], np.float32))
    size = 4096
    for m in torch.tensor(mats, device=cuda_device):
        clip = raster.transform_vertices(positions, m)
        bins = raster_binned.depth_bins(clip, indices, size, size)
        got = raster_binned.depth_binned_cuda(bins, size, size)
        assert torch.equal(got, raster_binned.depth_binned_plain(bins, size, size))
        exact = raster_binned.depth_exact(clip, indices, size, size)
        covered = exact < 1.0
        assert int(covered.sum()) > 0
        assert torch.equal(got < 1.0, covered)
        assert float((got.double() - exact)[covered].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_k4_spreads_a_crowded_tile_over_items_bit_for_bit(cuda_device):
    """A crowd of small triangles over a few tiles (several thousand rows in
    one tile, so several items; triangles straddling tile edges, so rows in
    two segments) under a global list of a few large triangles: K4's depth
    is its plain version's bit for bit."""
    width, height, n = 1024, 256, 12000
    rng = np.random.default_rng(23)
    centers = np.stack([rng.normal(0.0, 0.08, n), rng.normal(0.0, 0.12, n),
                        rng.uniform(-0.5, 0.5, n)], 1)
    tris = centers[:, None] + rng.normal(0, 0.01, (n, 3, 3))
    big = rng.uniform(-6, 6, (6, 3, 3)) * [1, 1, 0.05]
    v = np.concatenate([tris, big]).reshape(-1, 3).astype(np.float32)
    clip = np.stack([v[:, 0], v[:, 1], 0.5 + 0.4 * v[:, 2], np.ones(len(v))], -1)
    clip = torch.tensor(clip, dtype=torch.float32, device=cuda_device)
    idx = torch.arange(len(v), dtype=torch.int32, device=cuda_device).reshape(-1, 3)
    rows = raster_binned.tri_rows(clip, idx, width, height)
    bins = raster_binned.bin_triangles(rows, width, height)
    plan = raster_binned.depth_plan(bins)
    per_tile = plan.ends[:-1] - torch.cat([plan.ends.new_zeros(1), plan.ends[:-2]])
    assert int(bins.g_count) >= 1
    assert int(bins.counts.max()) > 2 * raster_binned.K4_ITEM_ROWS
    assert int((per_tile > 2).sum()) >= 1
    binned = rows.valid & ~rows.is_global
    assert int((binned & ((rows.span_w > 1) | (rows.span_h > 1))).sum()) > 100  # straddlers
    got = raster_binned.depth_binned_cuda(bins, width, height)
    want = raster_binned.depth_binned_plain(bins, width, height)
    assert (want < 1.0).float().mean() > 0.3
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("vis", [False, True])
def test_plan_kernel_matches_plain_on_card(cuda_device, vis):
    """The plan K4 and K5 launch with (`depth_plan` on CUDA bins: the plan
    kernel) is its plain version's, item counter included, on the soup
    and on a crowd whose tiles need several items each; more tiles than
    the kernel's block takes in one pass."""
    bins, _, _ = _raster_bins(cuda_device, vis=vis)
    crowd, _, _ = _raster_bins(cuda_device, vis=vis, width=256, height=64)
    wide, _, _ = _raster_bins(cuda_device, vis=vis, n=200000, width=8192, height=8192)
    assert int(crowd.counts.min()) > 2 * raster_binned.K4_ITEM_ROWS
    assert wide.nx * wide.ny > 1024
    for b in (bins, crowd, wide):
        got, want = raster_binned.depth_plan(b), raster_binned.depth_plan_plain(b)
        assert torch.equal(got.gmeta, want.gmeta)  # (g_count, g_items), on the device
        assert int(got.gmeta[0]) == int(b.g_count)
        assert torch.equal(got.ends, want.ends)


def _assert_vis_equal(got, want):
    """K5 against its plain version: triangle ids bit-equal, depth and
    barycentrics within 1e-5 (chip_smoke.py's VIS_ATOL; both compute them
    in one operation order from the same winning row)."""
    assert torch.equal(got.tri, want.tri)
    for a, b in zip((got.depth, got.bary_u, got.bary_v), (want.depth, want.bary_u, want.bary_v)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


@pytest.mark.cuda
def test_k5_matches_plain_on_card(cuda_device):
    bins, w, h = _raster_bins(cuda_device, vis=True)
    got = raster_binned.vis_binned_cuda(bins, w, h)
    want = raster_binned.vis_binned_plain(bins, w, h)
    assert (want.tri >= 0).float().mean() > 0.5
    _assert_vis_equal(got, want)


@pytest.mark.cuda
def test_k5_spreads_a_crowded_tile_and_keeps_the_last_of_ties(cuda_device):
    """K5 on a crowded tile cut into several items, under a global list of
    large triangles, with every triangle drawn twice (the later copy wins
    its tie): its plain version's buffer, ids bit for bit, whatever order
    the items run in."""
    width, height, n = 1024, 256, 6000
    rng = np.random.default_rng(29)
    centers = np.stack([rng.normal(0.0, 0.08, n), rng.normal(0.0, 0.12, n),
                        rng.uniform(-0.5, 0.5, n)], 1)
    tris = centers[:, None] + rng.normal(0, 0.01, (n, 3, 3))
    big = rng.uniform(-6, 6, (6, 3, 3)) * [1, 1, 0.05]
    tris = np.concatenate([tris, big])
    v = np.concatenate([tris, tris]).reshape(-1, 3).astype(np.float32)
    clip = np.stack([v[:, 0], v[:, 1], 0.5 + 0.4 * v[:, 2], np.ones(len(v))], -1)
    clip = torch.tensor(clip, dtype=torch.float32, device=cuda_device)
    idx = torch.arange(len(v), dtype=torch.int32, device=cuda_device).reshape(-1, 3)
    bins = raster_binned.bin_triangles(
        raster_binned.tri_rows(clip, idx, width, height, vis=True), width, height)
    assert int(bins.g_count) >= 2
    assert int(bins.counts.max()) > 2 * raster_binned.K4_ITEM_ROWS
    want = raster_binned.vis_binned_plain(bins, width, height)
    assert (want.tri >= 0).float().mean() > 0.3
    assert int((want.tri >= len(v) // 6).sum()) > 0  # later copies won ties
    for _ in range(3):
        _assert_vis_equal(raster_binned.vis_binned_cuda(bins, width, height), want)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["RASTERIZED", "MINIMAL"])
def test_raster_frames_on_card_match_cpu(cuda_device, mode):
    size = 64
    # The CPU frame takes K4's and K5's plain versions: the brute path's
    # depth rounds differently and flips shadow taps at the bias.
    cfg = StaticConfig(shadow_map_size=128, cubemap_size=16, cubemap_mips=4,
                       irradiance_size=8, brdf_lut_size=16, mc_grid=8, raster_method="binned")

    def render(device):
        app = Application(size, size, getattr(RenderGraphMode, mode), cfg=cfg, device=device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
        app.create_scene()
        return app.render_frame()["present_output"].cpu().numpy()

    traversal.K1_LAUNCHES.clear()
    raster_binned.K4_LAUNCHES = raster_binned.K5_LAUNCHES = raster_binned.BIN_LAUNCHES = 0
    got = render(cuda_device)
    raster = mode == "RASTERIZED"
    assert dict(traversal.K1_LAUNCHES) == (
        {"closest": 2, "any_hit": 1} if raster else {"closest": 1})
    assert (raster_binned.K4_LAUNCHES, raster_binned.K5_LAUNCHES) == (4, int(raster))
    # each raster call's binning
    assert raster_binned.BIN_LAUNCHES == raster_binned.BIN_KERNELS * (4 + int(raster))
    diff = np.abs(got - render("cpu"))
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert diff.mean() <= 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["RASTERIZED", "MINIMAL"])
def test_raster_loop_captured_without_host_sync_on_card(cuda_device, mode):
    """`run_on_device(4)` of the RASTERIZED (marching-cubes draw on) and
    MINIMAL apps at 64² on the card under torch.cuda.set_sync_debug_mode(
    "error"), so that any host sync raises: captured once (frame 1 eagerly,
    the capture, 3 replays), then 4 frames of pure replay. The frames carry
    no state, so each call's last frame is a host frame with the clock
    pinned, bit for bit; the first call moves the kernels' counters by two
    frames' worth (frame 1 and the capture's recording), the second by
    none."""
    size = 64
    cfg = StaticConfig(shadow_map_size=128, cubemap_size=16, cubemap_mips=4,
                       irradiance_size=8, brdf_lut_size=16, mc_grid=8)

    def make():
        app = Application(size, size, getattr(RenderGraphMode, mode), cfg=cfg,
                          device=cuda_device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
        app.create_scene()
        app.run(1)  # the environment captured and every kernel built
        return app

    host, loop = make(), make()
    want = host.run(1)
    raster = mode == "RASTERIZED"
    for moved in (2, 0):
        raster_binned.K4_LAUNCHES = raster_binned.K5_LAUNCHES = 0
        previous = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("error")
        try:
            img = loop.run_on_device(4, tstep=0.0)
        finally:
            torch.cuda.set_sync_debug_mode(previous)
        assert loop.graph.device_loop_unsupported_reason() is None
        assert loop.graph.last_loop_form == "captured"
        assert loop.graph.captures == 1
        assert (raster_binned.K4_LAUNCHES, raster_binned.K5_LAUNCHES) == (
            4 * moved, int(raster) * moved)
        np.testing.assert_array_equal(img.cpu().numpy(), want)
    assert float(img.std()) > 0.01


@pytest.mark.cuda
@pytest.mark.parametrize("sky_mode", ["exact", "cubemap"])
def test_pt_loop_captured_matches_host_loop_on_card(cuda_device, sky_mode):
    """`run_on_device` on the card: a 64² PT loop, captured into a CUDA
    graph, against the host loop (`run`), 3 frames and then 2 more (pure
    replay): the carried state bit for bit, one capture, and the counters
    mirrored on the host."""
    size = 64
    cfg = StaticConfig(num_bounces=3, sky_mode=sky_mode, cubemap_size=16, cubemap_mips=2,
                       irradiance_size=8, brdf_lut_size=16)

    def make():
        app = Application(size, size, cfg=cfg, device=cuda_device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        return app

    host, loop = make(), make()
    for n in (3, 2):
        want = host.run(n)
        img = loop.run_on_device(n, tstep=0.0)
        assert loop.graph.last_loop_form == "captured"
        assert loop.graph.captures == 1
        assert host.total_samples == loop.total_samples
        for name, state in host.graph.state.items():
            assert torch.equal(loop.graph.state[name], state), name
        assert img.device.type == "cuda"
        np.testing.assert_array_equal(img.cpu().numpy(), want)


def _mc_result(grid=8, time=1.7):
    """The reference SDF scaled into a grid^3 region, extracted on the CPU."""
    density = lambda p, t: marching_cubes.default_density(p * (32.0 / grid), t)
    return marching_cubes.marching_cubes(density_fn=density, grid=grid, time=time,
                                         device="cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_k1_on_refit_tree_matches_plain_on_card(cuda_device, any_hit):
    grid = 8
    res = _mc_result(grid)
    tables = mc_bvh.build_dynamic_tables(
        marching_cubes.MarchingCubesResult(*(x.to(cuda_device) for x in res)), grid)
    for name, t in mc_bvh.build_dynamic_tables(res, grid).items():  # bit for bit
        assert torch.equal(tables[name].cpu().view(torch.int32), t.view(torch.int32)), name
    dyn = mc_bvh.dynamic_scene_from_tables(tables, grid, 0)
    rng = np.random.default_rng(11)
    o = (grid / 2.0 + rng.normal(0, grid, (4096, 3))).astype(np.float32)
    d = (grid / 2.0 + rng.normal(0, grid / 3, (4096, 3)) - o).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    o, d = (torch.tensor(x, device=cuda_device) for x in (o, d))
    traversal.K1_LAUNCHES.clear()
    t, prim, _, _ = mc_bvh.dyn_traverse(dyn, o, d, 1e-3, 1e4, any_hit=any_hit)
    assert dict(traversal.K1_LAUNCHES) == {"any_hit" if any_hit else "closest": 1}
    n = o.shape[0]
    tp, pp, _, _ = traversal.traverse_plain(
        dyn.bvh.node_packed, dyn.bvh.leaf_packed, o, d, torch.full((n,), 1e-3, device=o.device),
        torch.full((n,), 1e4, device=o.device), any_hit)
    hit = pp >= 0
    assert int(hit.sum()) > 200
    assert torch.equal(prim >= 0, hit)
    if not any_hit:
        assert torch.allclose(t[hit], tp[hit], rtol=1e-6, atol=0)
        off = hit & (prim != pp)
        assert torch.equal(t[off], tp[off])


def _mc_cube_app(device, size=64):
    app = Application(size, size, cfg=StaticConfig(num_bounces=3, mc_grid=8), device=device)
    app.fps_timer.elapsed_seconds = lambda: 1.7
    app.view = app.view.replace(marching_cubes_enabled=np.int32(1))

    def build(r, cam):
        create_cube_scene(r, cam)
        r.add_light([16.0, 34.0, 16.0], [1.0, 1.0, 1.0], 1.0)

    app.create_scene(build)
    app.camera.set_position_target([58.0, 38.0, 58.0], [10.0, 18.0, 10.0])
    return app


@pytest.mark.cuda
def test_mc_pt_frame_and_loop_on_card(cuda_device):
    """The PT frame with the traced isosurface: the card's frame against the
    CPU's (K1 twice a query, the seed kernel on the static tree only), and a
    captured 3-frame loop against the host loop bit for bit."""
    traversal.K1_LAUNCHES.clear()
    torch_bvh.SEED_LAUNCHES = 0
    app = _mc_cube_app(cuda_device)
    got = app.run(1)
    assert dict(traversal.K1_LAUNCHES) == {"closest": 2 * (1 + 3), "any_hit": 2 * 3}
    assert torch_bvh.SEED_LAUNCHES == 3
    diff = np.abs(got - _mc_cube_app("cpu").run(1))
    assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
    assert diff.mean() <= 1e-3
    host, loop = _mc_cube_app(cuda_device), _mc_cube_app(cuda_device)
    want = host.run(3)
    img = loop.run_on_device(3, tstep=0.0)
    assert loop.graph.last_loop_form == "captured" and loop.graph.captures == 1
    for name, state in host.graph.state.items():
        assert torch.equal(loop.graph.state[name], state), name
    np.testing.assert_array_equal(img.cpu().numpy(), want)


@pytest.mark.cuda
def test_raster_gbuffer_pass_on_card_matches_cpu(cuda_device):
    size = 96
    apps = {}
    for device in ("cpu", cuda_device):
        apps[str(device)] = Application(size, size, cfg=StaticConfig(), device=device)
        apps[str(device)].create_scene()
        apps[str(device)]._refresh_view()
    cpu = apps["cpu"]
    view = cpu.view.to("cpu")
    clip = raster.transform_vertices(cpu.scene.positions, view.projection @ view.view)
    vis = raster.rasterize(clip, cpu.scene.indices, size, size, method="binned")
    want = dict(zip(GBUFFER_PLANES, gbuffer.from_visibility(cpu.scene, vis)))
    card = apps[str(cuda_device)]
    g = Graph(device=cuda_device)
    setup_gbuffer_pass(g, None, size, size, use_raycast=False)
    raster_binned.K5_LAUNCHES = 0
    got = {k: v.cpu() for k, v in g.render(card.scene, card.view).items()}
    assert raster_binned.K5_LAUNCHES == 1
    assert float((want["gbuffer_depth"] < 1.0).float().mean()) > 0.3
    assert torch.equal(got["gbuffer_pbr"][..., 3], want["gbuffer_pbr"][..., 3])
    for name, ref in want.items():
        assert torch.allclose(got[name], ref, rtol=1e-4, atol=1e-4), name


@pytest.mark.cuda
def test_captured_loop_sanitizer_counts_on_card(cuda_device):
    """The sanitizer in the captured loop: a pass that writes one NaN a frame
    reports N for an N-frame call, on the capture's call and on a replay
    (the counts are device tensors the captured body adds to, zeroed before
    each call), and the loop stays captured."""
    g = Graph(device=cuda_device, sanitize=True)
    g.create_texture("present_output", 8, 8, 3)

    def bad(res, scene, view):
        img = torch.zeros((8, 8, 3), device=cuda_device)
        img.view(-1)[:1].fill_(float("nan"))  # no host copy: capture-safe
        return {"present_output": img}

    g.add_pass("bad").write("present_output").render(bad).build()
    from rust_renderer_tpu_torch.settings import RenderSettings

    for n in (3, 2):
        g.render_loop(None, RenderSettings.default(), n)
        assert g.last_loop_form == "captured" and g.captures == 1
        assert g.last_sanitizer_report == {"bad/present_output": n}


@pytest.mark.cuda
def test_pt_loop_with_sanitizer_stays_captured_on_card(cuda_device):
    """`run_on_device` with sanitize on: captured, nothing reported, and the
    state bit-equal to the host loop's with sanitize off."""
    cfg = StaticConfig(num_bounces=3)

    def make(sanitize):
        app = Application(64, 64, cfg=cfg, sanitize=sanitize, device=cuda_device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        return app

    host, loop = make(False), make(True)
    want = host.run(3)
    img = loop.run_on_device(3, tstep=0.0)
    assert loop.graph.last_loop_form == "captured"
    assert loop.graph.last_sanitizer_report == {}
    for name, state in host.graph.state.items():
        assert torch.equal(loop.graph.state[name], state), name
    np.testing.assert_array_equal(img.cpu().numpy(), want)


@pytest.mark.cuda
def test_cuda_library_reloads_a_changed_source(cuda_device, tmp_path, monkeypatch):
    """One small library built twice from two versions of its source: the
    second load runs the second version's kernel (the library is named by
    its sources' hash, `native.load_library`)."""
    from rust_renderer_tpu_torch import native

    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    src = tmp_path / "version.cu"
    out = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    for version in (1, 2):
        src.write_text(
            "#include <cuda_runtime.h>\n"
            f"__global__ void write_version(int* out) {{ *out = {version}; }}\n"
            'extern "C" int run(void* out) {\n'
            "  write_version<<<1, 1>>>(static_cast<int*>(out));\n"
            "  return static_cast<int>(cudaGetLastError());\n}\n")
        lib = native.load_library("hot_version", [str(src)], native.nvcc_command())
        lib.run.restype = ctypes.c_int
        lib.run.argtypes = [ctypes.c_void_p]
        assert lib.run(out.data_ptr()) == 0
        torch.cuda.synchronize()
        assert int(out) == version


@pytest.mark.cuda
def test_set_instance_transform_captures_anew_on_card(cuda_device):
    """After the metal sphere moves, the next `run_on_device` captures anew
    (the old capture held the old scene's tensors), the old capture is
    freed, and the loop stays bit-equal to the host loop."""
    import gc
    import weakref

    def make():
        app = Application(64, 64, cfg=StaticConfig(num_bounces=3), device=cuda_device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        return app

    host, loop = make(), make()
    metal = len(loop.renderer.instances) - 2
    move = np.array(loop.renderer.instances[metal].transform, np.float32)
    move[:3, 3] += [0.5, -0.4, 1.0]
    host.run(2)
    loop.run_on_device(2, tstep=0.0)
    old = weakref.ref(loop.graph._loop)
    for app in (host, loop):
        app.set_instance_transform(metal, move)
    want = host.run(2)
    img = loop.run_on_device(2, tstep=0.0)
    gc.collect()
    assert old() is None
    assert loop.graph.captures == 2 and loop.graph.last_loop_form == "captured"
    assert loop.graph._loop.scene is loop.scene
    for name, state in host.graph.state.items():
        assert torch.equal(loop.graph.state[name], state), name
    np.testing.assert_array_equal(img.cpu().numpy(), want)


FLAGSHIP_SIZE = 64


def _flagship_frames_on(device, group=None) -> dict:
    """Two flagship frames of the cube scene with 4 lights at 64² (2
    bounces; tests/test_torch_parallel.py's case) with the PT graph's hit
    queries (compaction windows, the seed test), one process (group None)
    or this rank's band over `group`: the whole output and spatial Y of
    each frame, and the K1 and seed launches."""
    import rust_renderer_tpu_torch as port
    from rust_renderer_tpu_torch.ops.restir import Reservoir
    from rust_renderer_tpu_torch.parallel import (
        flagship_step, render_flagship_tiled, shard_flagship_inputs, tiles)
    from rust_renderer_tpu_torch.settings import RenderSettings

    size = FLAGSHIP_SIZE
    r = port.Renderer()
    cam = port.Camera([-2.5, 3.0, -2.5], [10.0, 1.0, 10.0], aspect_ratio=1.0)
    create_cube_scene(r, cam)
    for i in range(4):
        r.add_light([float(i) * 4.0, 3.0, float(i % 2) * 4.0], [1.0, 1.0, 1.0])
    scene = r.pack(device=device)
    bvh = torch_bvh.build_scene_bvh(scene)
    cfg = StaticConfig(width=size, height=size, num_bounces=2)
    closest = torch_bvh.make_closest_hit(bvh, compact_window=cfg.compact_window,
                                         compact_order=cfg.compact_order)
    any_hit = torch_bvh.make_any_hit(bvh, compact_window=cfg.compact_window_any,
                                     compact_order=cfg.compact_order, seed_rows=cfg.seed_rows)
    view = RenderSettings.default(num_lights=4).with_camera(cam, size, size)
    accum = torch.zeros((size, size, 3), device=device)
    res = Reservoir.empty((size, size), device=device)
    if group is not None:
        accum, res = shard_flagship_inputs(group, accum, res)
    traversal.K1_LAUNCHES.clear()
    torch_bvh.SEED_LAUNCHES = 0
    frames = []
    for k in range(2):
        v = view.replace(total_samples=np.uint32(k + 1)).to(device)
        if group is None:
            img, accum, res = flagship_step(scene, v, cfg, accum, res, closest, any_hit)
        else:
            img, accum, res = render_flagship_tiled(scene, v, cfg, accum, res, closest,
                                                    any_hit, group)
            img, y = tiles.gather_rows(img, group), tiles.gather_rows(res.Y, group)
        frames.append((img.cpu().numpy(), (res.Y if group is None else y).cpu().numpy()))
    return {"frames": frames, "k1": dict(traversal.K1_LAUNCHES),
            "seed": torch_bvh.SEED_LAUNCHES}


def _flagship_cuda_rank(rank, n):
    from rust_renderer_tpu_torch.parallel import make_tile_group

    group, _ = make_tile_group(backend="gloo", device="cuda")
    return _flagship_frames_on(torch.device("cuda"), group)


@pytest.mark.cuda
def test_flagship_tiled_on_card_matches_one_rank(cuda_device, tmp_path):
    """render_flagship_tiled on 2 gloo ranks sharing the card (CUDA tensors),
    two frames, against flagship_step in one process on the card: spatial
    Y bit-equal, output within 2e-5; every rank launches K1 (2 + 2
    closest, 2 any-hit a frame) and the seed kernel (2 a frame)."""
    from rust_renderer_tpu_torch.parallel import spawn_ranks

    want = _flagship_frames_on(cuda_device)
    ranks = spawn_ranks(_flagship_cuda_rank, 2, str(tmp_path))
    for rank in ranks:
        for (img, y), (ref, ref_y) in zip(rank["frames"], want["frames"]):
            np.testing.assert_array_equal(y, ref_y)
            np.testing.assert_allclose(img, ref, atol=2e-5)
        assert rank["k1"] == want["k1"] == {"closest": 2 * 3, "any_hit": 2 * 2}
        assert rank["seed"] == want["seed"] == 2 * 2
