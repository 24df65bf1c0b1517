"""The port's rasterizer against the JAX package's: the binning host side,
the plain versions of kernels K4 (depth) and K5 (visibility buffer), and the
brute path that CPU tensors take.

Inputs are made with numpy from a seed and given to both packages.
Tolerances (those of tests/test_raster_binned.py, tighter where the port
meets them):
- the binning tables (`starts`, `counts`, the global count) are equal, and
  the triangle rows agree to 1e-6 (relative, floor 1e-6) in the columns
  both have (the port's rows hold the depth's gradient where the JAX rows
  hold two vertex depths, and the first vertex's screen position);
  given the same triangle rows, the live rows of the two tables (each
  tile's segment, the global list) are bit-equal and in the same order;
- the port's binning has static shapes (they follow the triangle count and
  the image size alone) and reads nothing back to the host;
- depth agrees to 1e-4 where both cover a pixel, and coverage differs on
  under 0.5% of the pixels (edge-function rounding on boundary pixels);
  left out are the pixels where the float64 interpolation shows the JAX
  kernel's depth to be the inexact one (it interpolates with the absolute
  edge functions, which cancel in float32), under 1% of them;
- the visibility buffer names the same triangle on at least 98% of the
  pixels both cover (depth ties may break either way: the JAX package's
  sort does not promise stability) with barycentrics within 2e-3;
- the brute path names the same triangle on every pixel, with depth and
  barycentrics within 1e-5;
- K4's work plan covers every (tile, row) pair once, the boxes its items
  test rows on are the plain version's, and folding its items gives the
  plain version's depth bit for bit; K5's the same over visibility bins.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu.ops import raster as jax_raster
from rust_renderer_tpu.ops import raster_binned as jax_binned

from rust_renderer_tpu_torch.convert import visibility_from_numpy
from rust_renderer_tpu_torch.ops import raster, raster_binned

torch.set_num_threads(1)

W, H = 768, 64  # 3 x 2 tiles: a screen-wide triangle spans more than SPAN_X


def _mesh(n, seed, spread=1.2, size=0.25):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-spread, spread, (n, 1, 3))
    tris = centers + rng.normal(0, size, (n, 3, 3))
    return (tris.reshape(-1, 3).astype(np.float32),
            np.arange(n * 3, dtype=np.int32).reshape(n, 3))


def _clip(verts, persp=True, z_off=3.0):
    """Perspective (ndc z = 0.55 - 0.1 / z_view) or orthographic (w = 1)."""
    x, y, z = verts[:, 0], verts[:, 1], verts[:, 2] + z_off
    if persp:
        return np.stack([x * 1.5, y * 1.5 * W / H / 2, 0.55 * z - 0.1, z], -1).astype(np.float32)
    return np.stack([x * 0.6, y * 0.6 * W / H / 2, z * 0.2, np.ones_like(x)], -1).astype(np.float32)


def _with_floor(verts, idx):
    """Adds one triangle that covers the whole screen (the global list)."""
    floor = np.array([[-50, -50, 0.5], [50, -50, 0.5], [0, 80, 0.5]], np.float32)
    n = len(verts)
    return (np.concatenate([verts, floor]),
            np.concatenate([idx, np.array([[n, n + 1, n + 2]], np.int32)]))


CASES = {
    "persp": lambda: (*_mesh(2000, 3), True),
    "ortho": lambda: (*_mesh(2000, 4), False),
    "global": lambda: (*_with_floor(*_mesh(300, 7)), False),
}


def _both(verts, idx, persp):
    clip = _clip(verts, persp)
    return (jnp.asarray(clip), jnp.asarray(idx)), (torch.tensor(clip), torch.tensor(idx))


@pytest.mark.parametrize("vis", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tri_rows_and_bins_match_jax(case, vis):
    (jc, ji), (tc, ti) = _both(*CASES[case]())
    want = jax_binned._tri_rows(jc, ji, W, H, vis=vis)
    got = raster_binned.tri_rows(tc, ti, W, H, vis=vis)
    jax_rows = torch.tensor(np.asarray(want[0]))
    np.testing.assert_allclose(_jax_layout(got.rows, jax_rows).numpy(), jax_rows.numpy(),
                               rtol=1e-6, atol=1e-6)
    tri_pos, _, _ = raster.clip_triangles_near(tc, ti)
    screen, _ = raster.clip_to_screen(tri_pos.reshape(-1, 4), W, H)
    first = screen.reshape(-1, 3, 3)[:, 0, :2]
    assert torch.equal(got.rows[got.valid, 13:15], first[got.valid])
    for name, a, b in zip(("tx0", "ty0", "span_w", "span_h"), got[1:5], want[1:5]):
        ok = np.asarray(want[5])
        np.testing.assert_array_equal(a.numpy()[ok], np.asarray(b)[ok], err_msg=name)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want[5]))
    np.testing.assert_array_equal(got.is_global.numpy(), np.asarray(want[6]))
    nx, ny = -(-W // jax_binned.TILE_W), -(-H // jax_binned.TILE_H)
    stride = jax_binned.VIS_STRIDE if vis else jax_binned.DEPTH_STRIDE
    packed, starts, counts, g_group, g_count = jax_binned._bin_pairs(*want, nx, ny, stride)
    bins = raster_binned.bin_triangles(got, W, H)
    np.testing.assert_array_equal(bins.starts.numpy(), np.asarray(starts))
    np.testing.assert_array_equal(bins.counts.numpy(), np.asarray(counts))
    assert int(bins.g_count) == int(g_count)
    assert int(bins.g_count) >= (1 if case == "global" else 0)
    _assert_static_layout(bins, got.rows.shape[0], W, H, vis)

    # JAX's rows binned by the port: the live rows bit-equal, in JAX's order.
    same = raster_binned.bin_triangles(_port_tri_rows(want, got.box), W, H)
    width = want[0].shape[1]  # the JAX rows' columns, which the port bins as they are
    jax_table = np.asarray(packed).reshape(-1, stride)[:, :width]
    n_seg, g = int(np.asarray(counts).sum()), int(g_count)
    jax_g = int(g_group) * (128 // stride)
    assert int(same.counts.sum()) == n_seg and int(same.g_count) == g
    np.testing.assert_array_equal(same.table[:n_seg].numpy(), jax_table[:n_seg])
    np.testing.assert_array_equal(same.table[same.g_base:same.g_base + g].numpy(),
                                  jax_table[jax_g:jax_g + g])


def _jax_layout(rows, jax_rows):
    """The port's rows in the layout of the JAX package's `jax_rows`: the
    edge functions, the first vertex's depth, the area, and a visibility
    row's columns after its depth row. Where the JAX rows hold the other
    two vertices' depths, the port's hold the depth's gradient: those two
    depths are taken from the JAX rows, once the port's gradient is found
    to be the gradient of the JAX rows' plane (relative 1e-5 of the plane's
    slope). The first vertex's position (columns 13-14), which the JAX rows
    lack, is left out, and the JAX rows' padding is zero."""
    out = torch.zeros_like(jax_rows)
    out[:, :13] = rows[:, :13]
    out[:, 10:12] = jax_rows[:, 10:12]
    if rows.shape[1] == raster_binned.VIS_STRIDE:
        out[:, 13:23] = rows[:, 16:26]
    q = jax_rows.double()
    dz1, dz2 = q[:, 10] - q[:, 9], q[:, 11] - q[:, 9]
    for col, (a2, a0) in ((10, (6, 0)), (11, (7, 1))):  # dzdx, dzdy
        terms = (q[:, a2] * dz1, q[:, a0] * dz2)
        want = (terms[0] + terms[1]) * q[:, 12]
        scale = (terms[0].abs() + terms[1].abs()) * q[:, 12]
        assert bool(((rows[:, col].double() - want).abs() <= 1e-5 * scale + 1e-12).all())
    return out


def _port_tri_rows(want, box) -> raster_binned.TriRows:
    """The JAX package's `_tri_rows` outputs as the port's TriRows, with
    the port's pixel boxes `box`."""
    rows, tx0, ty0, span_w, span_h, valid, is_global = (
        torch.tensor(np.asarray(x)) for x in want)
    return raster_binned.TriRows(rows, tx0.long(), ty0.long(), span_w.long(), span_h.long(),
                                 valid, is_global, box)


def _assert_static_layout(bins, t2, width, height, vis):
    """The table is [SPAN_X * SPAN_Y * 2T segment slots | 2T global
    slots]; the rows no walk reads are dead, with an empty box and no
    tile."""
    slots = raster_binned.SPAN_X * raster_binned.SPAN_Y * t2
    stride = raster_binned.VIS_STRIDE if vis else raster_binned.DEPTH_STRIDE
    assert bins.g_base == slots
    assert bins.table.shape == (slots + t2, stride)
    assert (bins.nx, bins.ny) == (-(-width // raster_binned.TILE_W),
                                  -(-height // raster_binned.TILE_H))
    assert bins.starts.shape == bins.counts.shape == (bins.nx * bins.ny,)
    assert bins.g_count.shape == () and bins.g_count.dtype == torch.int32
    rows = torch.arange(slots + t2)
    live = (rows < int(bins.counts.sum())) | (
        (rows >= slots) & (rows < slots + int(bins.g_count)))
    x0, x1, y0, y1 = bins.row_box
    assert bins.row_tile.shape == rows.shape and all(b.shape == rows.shape for b in bins.row_box)
    assert bool(((x1 < x0) | (y1 < y0))[~live].all())
    assert bool((bins.row_tile[~live] == -1).all())
    assert bool((bins.row_tile[:int(bins.counts.sum())] >= 0).all())
    assert torch.equal(bins.table[~live],
                       raster_binned.dead_row(stride, "cpu").expand(int((~live).sum()), -1))


def test_binning_shapes_follow_the_triangle_count_alone():
    """Two triangle sets of one count at other positions (one with a
    screen-wide triangle) give Bins of the same shapes and g_base."""
    a = _bins("global")
    verts, idx = _mesh(301, 11, spread=0.6)
    b = raster_binned.bin_triangles(raster_binned.tri_rows(
        torch.tensor(_clip(verts, True)), torch.tensor(idx), W, H), W, H)
    assert int(a.g_count) != int(b.g_count) and not torch.equal(a.counts, b.counts)
    assert a.g_base == b.g_base
    for x, y in zip(a, b):
        for p, q in (zip(x, y) if isinstance(x, tuple) else [(x, y)]):
            if torch.is_tensor(p):
                assert (p.shape, p.dtype) == (q.shape, q.dtype)
            else:
                assert p == q


def _refuse(name):
    def read(*args, **kwargs):
        raise AssertionError(f"host read: {name}")
    return read


@pytest.mark.parametrize("vis", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_binning_and_plan_read_nothing_back_to_the_host(case, vis, monkeypatch):
    """tri_rows, bin_triangles and the plan (on CPU bins its plain version,
    which the plan kernel's launch replaces on the card) run with every
    host read raising: torch.nonzero, Tensor.nonzero, .item, .tolist,
    .cpu, .numpy, int(), float(), bool(), index() and boolean-mask
    indexing. What they give equals the unguarded run's."""
    verts, idx, persp = CASES[case]()
    clip, ti = torch.tensor(_clip(verts, persp)), torch.tensor(idx)
    want_bins = raster_binned.bin_triangles(raster_binned.tri_rows(clip, ti, W, H, vis), W, H)
    want_plan = raster_binned.depth_plan(want_bins)
    getitem, setitem = torch.Tensor.__getitem__, torch.Tensor.__setitem__

    def no_mask(index):
        parts = index if isinstance(index, tuple) else (index,)
        if any(torch.is_tensor(p) and p.dtype == torch.bool for p in parts):
            raise AssertionError("host read: boolean mask indexing")

    with monkeypatch.context() as m:
        m.setattr(torch, "nonzero", _refuse("torch.nonzero"))
        for name in ("nonzero", "item", "tolist", "cpu", "numpy", "__int__", "__float__",
                     "__bool__", "__index__"):
            m.setattr(torch.Tensor, name, _refuse(f"Tensor.{name}"))
        m.setattr(torch.Tensor, "__getitem__", lambda t, i: (no_mask(i), getitem(t, i))[1])
        m.setattr(torch.Tensor, "__setitem__", lambda t, i, v: (no_mask(i), setitem(t, i, v))[1])
        bins = raster_binned.bin_triangles(raster_binned.tri_rows(clip, ti, W, H, vis), W, H)
        plan = raster_binned.depth_plan(bins)
    for got, want in zip((*bins, *plan), (*want_bins, *want_plan)):
        for p, q in (zip(got, want) if isinstance(got, tuple) else [(got, want)]):
            assert torch.equal(p, q) if torch.is_tensor(p) else p == q
    assert int(plan.gmeta[0]) == int(bins.g_count)


def _assert_depth_close(got, want, exact):
    """The port's depth `got` against the JAX kernel's `want` where both
    cover a pixel, but where `exact` (float64) shows the JAX depth to be
    the inexact one: off it by more than EXACT_ATOL where the port's is
    within it."""
    both = (got < 1.0) & (want < 1.0)
    assert both.mean() > 0.2, "coverage sanity"
    jax_inexact = (np.abs(want - exact) > EXACT_ATOL) & (np.abs(got - exact) <= EXACT_ATOL)
    assert (both & jax_inexact).sum() <= 0.01 * both.sum()
    keep = both & ~jax_inexact
    np.testing.assert_allclose(got[keep], want[keep], atol=1e-4)
    assert ((got < 1.0) != (want < 1.0)).mean() < 0.005


# The binned depth's largest gap to the float64 interpolation at its own
# coverage (ops/raster_binned.py::depth_exact).
EXACT_ATOL = 1e-5


@functools.cache
def _exact_depth(case):
    (_, _), (tc, ti) = _both(*CASES[case]())
    return raster_binned.depth_exact(tc, ti, W, H).numpy()


@pytest.mark.parametrize("case", sorted(CASES))
def test_depth_plain_matches_jax_binned(case):
    (jc, ji), (tc, ti) = _both(*CASES[case]())
    want = np.asarray(jax_binned.rasterize_depth_binned(jc, ji, W, H, interpret=True))
    launches = raster_binned.K4_LAUNCHES
    got = raster_binned.rasterize_depth_binned(tc, ti, W, H).numpy()
    assert raster_binned.K4_LAUNCHES == launches  # CPU tensors: the plain version
    assert got.shape == (H, W)
    _assert_depth_close(got, want, _exact_depth(case))


# K4's work plan (ops/raster_binned.py::depth_plan), at the kernel's item
# size and at a small one that cuts every tile's segment into several items.
ITEM_ROWS = [raster_binned.K4_ITEM_ROWS, 37]


def _bins(case):
    (_, _), (tc, ti) = _both(*CASES[case]())
    return raster_binned.bin_triangles(raster_binned.tri_rows(tc, ti, W, H), W, H)


@pytest.mark.parametrize("item_rows", ITEM_ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_plan_covers_every_tile_row_pair_once(case, item_rows, monkeypatch):
    """The items walk each tile's global rows and segment rows, each once,
    and no item holds more than K4_ITEM_ROWS rows."""
    monkeypatch.setattr(raster_binned, "K4_ITEM_ROWS", item_rows)
    bins = _bins(case)
    tile, first, rows = raster_binned.depth_plan_items(bins, raster_binned.depth_plan(bins))
    assert int(rows.min()) >= 1 and int(rows.max()) <= item_rows
    pairs = torch.cat([torch.stack([torch.full((n,), t), torch.arange(f, f + n)], 1)
                       for t, f, n in zip(tile.tolist(), first.tolist(), rows.tolist())])
    want = []
    for t in range(bins.nx * bins.ny):
        s, c = int(bins.starts[t]), int(bins.counts[t])
        walked = [*range(bins.g_base, bins.g_base + int(bins.g_count)), *range(s, s + c)]
        want += [(t, r) for r in walked]
    assert sorted(map(tuple, pairs.tolist())) == sorted(want)
    if item_rows < raster_binned.K4_ITEM_ROWS:
        assert int((rows == item_rows).sum()) > 0  # some tile needs several items


def _item_boxes(bins, tile, rows):
    """The boxes the kernels test rows `rows` of an item of `tile` on:
    Bins.row_box clipped to the tile (raster_binned.cu::tile_box)."""
    tx0, ty0 = (tile % bins.nx) * raster_binned.TILE_W, (tile // bins.nx) * raster_binned.TILE_H
    x0, x1, y0, y1 = (b[rows] for b in bins.row_box)
    return (x0.clamp_min(tx0), x1.clamp_max(tx0 + raster_binned.TILE_W - 1),
            y0.clamp_min(ty0), y1.clamp_max(ty0 + raster_binned.TILE_H - 1))


@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_boxes_are_the_plain_versions_pixel_boxes(case):
    """The (row, pixel) pairs K4's items test, each row on Bins.row_box
    clipped to the item's tile, are the pairs the plain version enumerates
    (`_row_pixel_pairs`: the triangle's box widened by one pixel, a segment
    row's clipped to its tile), each once."""
    bins = _bins(case)
    n_pix = W * H

    def pairs(chunks):
        return torch.cat([r * n_pix + py * W + px for r, px, py in chunks])

    want = pairs(raster_binned._row_pixel_pairs(bins, W, H))
    got = []
    items = raster_binned.depth_plan_items(bins, raster_binned.depth_plan(bins))
    for t, f, n in zip(*(x.tolist() for x in items)):
        rows = torch.arange(f, f + n)
        got += [(rows[j], px, py)
                for j, px, py in raster.pixel_pairs(*_item_boxes(bins, t, rows), 1 << 20)]
    got = pairs(got)
    assert want.numel() > 0
    assert torch.equal(torch.sort(got).values, torch.sort(want).values)
    assert torch.unique(got).numel() == got.numel()


def _fold_plan(bins, plan, width, height):
    """K4's function computed item by item as the kernel walks it: each row
    of an item on its box clipped to the item's tile, in `_depth`'s
    arithmetic, folded by a minimum onto a clear of 1.0."""
    out = torch.ones(height * width)
    for t, f, n in zip(*(x.tolist() for x in raster_binned.depth_plan_items(bins, plan))):
        rows = torch.arange(f, f + n)
        for j, px, py in raster.pixel_pairs(*_item_boxes(bins, t, rows), 1 << 20):
            z, inside, _, _ = raster_binned._depth(bins.table[rows[j]], px, py)
            out.scatter_reduce_(0, py * width + px, torch.where(inside, z, 3.0e38), "amin")
    return out.reshape(height, width)


@functools.cache
def _jax_depth(case):
    (jc, ji), _ = _both(*CASES[case]())
    return np.asarray(jax_binned.rasterize_depth_binned(jc, ji, W, H, interpret=True))


@pytest.mark.parametrize("item_rows", ITEM_ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_plan_fold_matches_plain_and_jax(case, item_rows, monkeypatch):
    """Folding the plan's items gives the plain version's depth bit for bit,
    and the JAX kernel's under test_depth_plain_matches_jax_binned's
    tolerance."""
    monkeypatch.setattr(raster_binned, "K4_ITEM_ROWS", item_rows)
    bins = _bins(case)
    got = _fold_plan(bins, raster_binned.depth_plan(bins), W, H)
    assert torch.equal(got, raster_binned.depth_binned_plain(bins, W, H))
    _assert_depth_close(got.numpy(), _jax_depth(case), _exact_depth(case))


def _vis_bins(case, copies=1):
    """Visibility bins of CASES[case]; with copies=2 every triangle is drawn
    twice, so each covered pixel has an exact depth tie."""
    verts, idx, persp = CASES[case]()
    verts = np.concatenate([verts] * copies)
    idx = np.concatenate([idx + k * len(idx) * 3 for k in range(copies)]).astype(np.int32)
    tc, ti = torch.tensor(_clip(verts, persp)), torch.tensor(idx)
    return raster_binned.bin_triangles(raster_binned.tri_rows(tc, ti, W, H, vis=True), W, H)


@pytest.mark.parametrize("item_rows", ITEM_ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_k5_plan_covers_every_tile_row_pair_once(case, item_rows, monkeypatch):
    """K5 takes K4's plan over the visibility bins: each tile's global rows
    and segment rows lie in exactly one item of that tile, and no item holds
    more than K4_ITEM_ROWS rows."""
    monkeypatch.setattr(raster_binned, "K4_ITEM_ROWS", item_rows)
    bins = _vis_bins(case)
    assert bins.table.shape[1] == raster_binned.VIS_STRIDE
    tile, first, rows = raster_binned.depth_plan_items(bins, raster_binned.depth_plan(bins))
    assert int(rows.min()) >= 1 and int(rows.max()) <= item_rows
    got = [(t, r) for t, f, n in zip(tile.tolist(), first.tolist(), rows.tolist())
           for r in range(f, f + n)]
    want = []
    for t in range(bins.nx * bins.ny):
        s, c = int(bins.starts[t]), int(bins.counts[t])
        want += [(t, r) for r in [*range(bins.g_base, bins.g_base + int(bins.g_count)),
                                  *range(s, s + c)]]
    assert sorted(got) == sorted(want)
    assert len(set(got)) == len(got)


def _fold_vis_plan(bins, plan, width, height):
    """K5's key pass computed item by item as the kernel walks it: each row
    of an item on its box clipped to the item's tile, its walk position
    from the item's place (global items first, then the segment's), the
    key's minimum taken per item and then over the items."""
    out = torch.full((height * width,), raster.INT64_MAX, dtype=torch.int64)
    for t, f, n in zip(*(x.tolist() for x in raster_binned.depth_plan_items(bins, plan))):
        rows = torch.arange(f, f + n)
        pos = torch.where(rows >= bins.g_base, rows - bins.g_base,
                          bins.g_count + rows - int(bins.starts[t]))
        item = torch.full_like(out, raster.INT64_MAX)
        for j, px, py in raster.pixel_pairs(*_item_boxes(bins, t, rows), 1 << 20):
            z, inside, _, _ = raster_binned._depth(bins.table[rows[j]], px, py)
            k = (raster.float_order_key(z) << 32) | (0x7FFFFFFF - pos[j])
            item.scatter_reduce_(0, py * width + px,
                                 torch.where(inside & (z <= 1.0), k, raster.INT64_MAX), "amin")
        out = torch.minimum(out, item)
    return out


@pytest.mark.parametrize("copies", [1, 2])
@pytest.mark.parametrize("item_rows", ITEM_ROWS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_k5_plan_fold_matches_plain(case, item_rows, copies, monkeypatch):
    """Folding the plan's items gives the plain version's key plane bit for
    bit, also where every pixel has a depth tie (the later copy's key wins),
    and its decode is the plain version's buffer."""
    monkeypatch.setattr(raster_binned, "K4_ITEM_ROWS", item_rows)
    bins = _vis_bins(case, copies)
    got = _fold_vis_plan(bins, raster_binned.depth_plan(bins), W, H)
    want = raster_binned.vis_keys_plain(bins, W, H)
    assert torch.equal(got, want)
    assert int((want != raster.INT64_MAX).sum()) > 0.2 * W * H
    vis = raster_binned.vis_decode_plain(bins, got, W, H)
    plain = raster_binned.vis_binned_plain(bins, W, H)
    for a, b in zip(vis, plain):
        assert torch.equal(a, b)
    if copies == 2:  # the later copy of each triangle wins its tie
        n = bins.table[:, raster_binned.VIS_ORIG].max().item() + 1
        covered = plain.tri >= 0
        assert bool((plain.tri[covered] >= n // 2).all())


def _assert_vis_close(got, want, same_share=0.98):
    g_tri, w_tri = got.tri.numpy(), np.asarray(want.tri)
    both = (g_tri >= 0) & (w_tri >= 0)
    assert both.mean() > 0.2
    assert ((g_tri >= 0) != (w_tri >= 0)).mean() < 0.005
    same = both & (g_tri == w_tri)
    assert same.sum() >= same_share * both.sum()
    np.testing.assert_allclose(got.depth.numpy()[same], np.asarray(want.depth)[same], atol=1e-4)
    for a, b in ((got.bary_u, want.bary_u), (got.bary_v, want.bary_v)):
        np.testing.assert_allclose(a.numpy()[same], np.asarray(b)[same], atol=2e-3)


@pytest.mark.parametrize("case", sorted(CASES) + ["init"])
def test_vis_plain_matches_jax_binned(case):
    init = (None, None)
    if case == "init":
        # The LOAD op: a second mesh depth-tested against the first one's buffer.
        (jc0, ji0), _ = _both(*_mesh(1500, 13), True)
        base = jax_raster.rasterize(jc0, ji0, W, H, method="brute")
        init = (base, visibility_from_numpy(base, "cpu"))
        args = (*_mesh(1000, 14), True)
    else:
        args = CASES[case]()
    (jc, ji), (tc, ti) = _both(*args)
    want = jax_binned.rasterize_binned(jc, ji, W, H, interpret=True, init=init[0])
    launches = raster_binned.K5_LAUNCHES
    got = raster_binned.rasterize_binned(tc, ti, W, H, init=init[1])
    assert raster_binned.K5_LAUNCHES == launches
    _assert_vis_close(got, want)


def test_binned_empty_scene():
    clip, idx = torch.zeros((0, 4)), torch.zeros((0, 3), dtype=torch.int32)
    depth = raster_binned.rasterize_depth_binned(clip, idx, 64, 32)
    assert torch.equal(depth, torch.ones((32, 64)))
    vis = raster_binned.rasterize_binned(clip, idx, 64, 32)
    assert (vis.tri == -1).all() and (vis.depth == 1.0).all()
    want = jax_binned.rasterize_depth_binned(jnp.zeros((0, 4)), jnp.zeros((0, 3), jnp.int32),
                                             64, 32, interpret=True)
    np.testing.assert_array_equal(depth.numpy(), np.asarray(want))


@pytest.mark.parametrize("persp", [True, False])
def test_brute_rasterize_matches_jax(persp):
    (jc, ji), (tc, ti) = _both(*_mesh(400, 21), persp)
    w, h = 128, 64
    want = jax_raster.rasterize(jc, ji, w, h, method="brute")
    got = raster.rasterize(tc, ti, w, h)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert (got.tri >= 0).float().mean() > 0.3
    for a, b in ((got.depth, want.depth), (got.bary_u, want.bary_u),
                 (got.bary_v, want.bary_v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    depth = raster.rasterize_depth(tc, ti, w, h)
    np.testing.assert_allclose(
        depth.numpy(), np.asarray(jax_raster.rasterize_depth(jc, ji, w, h, method="brute")),
        atol=1e-5)
    # The deferred resolve of a vertex attribute.
    attr = np.random.default_rng(5).normal(size=(tc.shape[0], 3)).astype(np.float32)
    np.testing.assert_allclose(
        raster.interpolate(got, ti, torch.tensor(attr)).numpy(),
        np.asarray(jax_raster.interpolate(want, ji, jnp.asarray(attr))), atol=1e-5)


def test_brute_ties_follow_the_chunk_fold():
    """Two coplanar copies of each triangle: within a 64-triangle chunk the
    first keeps the pixel, a later chunk takes it (LESS_OR_EQUAL)."""
    verts, idx = _mesh(40, 8)
    # Copy k of the mesh sits at triangle ids k*40 .. k*40+39, so copies 0
    # and 1 share chunk 0 and copy 2 starts chunk 1.
    idx = np.concatenate([idx, idx, idx])
    (jc, ji), (tc, ti) = _both(verts, idx, True)
    want = jax_raster.rasterize(jc, ji, 96, 64, method="brute")
    got = raster.rasterize(tc, ti, 96, 64)
    np.testing.assert_array_equal(got.tri.numpy(), np.asarray(want.tri))
    assert (got.tri.numpy() >= 64).mean() > 0.1  # pixels the later chunk took


def test_near_clipping_matches_jax():
    verts, idx = _mesh(200, 9, spread=3.0)
    clip = _clip(verts, True, z_off=0.5)  # many vertices behind the near plane
    want = jax_raster.clip_triangles_near(jnp.asarray(clip), jnp.asarray(idx))
    got = raster.clip_triangles_near(torch.tensor(clip), torch.tensor(idx))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    # Some triangles were cut in two: their second slot is live.
    assert np.abs(np.asarray(want[0])[len(idx):]).sum() > 0


def test_cpu_and_unknown_devices():
    verts, idx = _mesh(10, 1)
    clip, ti = torch.tensor(_clip(verts)), torch.tensor(idx)
    bins = raster_binned.bin_triangles(raster_binned.tri_rows(clip, ti, 64, 32), 64, 32)
    with pytest.raises(ValueError, match="CUDA"):
        raster_binned.depth_binned_cuda(bins, 64, 32)
    with pytest.raises(ValueError, match="device"):
        raster.rasterize(clip.to("meta"), ti.to("meta"), 64, 32)
    with pytest.raises(ValueError, match="device"):
        raster_binned.rasterize_depth_binned(clip.to("meta"), ti.to("meta"), 64, 32)
    with pytest.raises(ValueError, match="method"):
        raster.rasterize_depth(clip, ti, 64, 32, method="nope")


def test_binned_method_takes_the_plain_versions_on_cpu():
    (_, _), (tc, ti) = _both(*_mesh(500, 30), True)
    launches = (raster_binned.K4_LAUNCHES, raster_binned.K5_LAUNCHES)
    depth = raster.rasterize_depth(tc, ti, W, H, method="binned")
    assert torch.equal(depth, raster_binned.rasterize_depth_binned(tc, ti, W, H))
    vis = raster.rasterize(tc, ti, W, H, method="binned")
    for a, b in zip(vis, raster_binned.rasterize_binned(tc, ti, W, H)):
        assert torch.equal(a, b)
    assert (raster_binned.K4_LAUNCHES, raster_binned.K5_LAUNCHES) == launches


# -- the binned paths' interpolation at texel coordinates in the thousands ----
#
# The JAX kernels interpolate depth as (e1·z0 + e2·z1 + e0·z2) / area from
# the absolute edge functions A·x + B·y + C, whose terms cancel in float32
# far from the origin: on a 4096² shadow cascade a few texels' depth was off
# by up to 0.03. The port interpolates from the first vertex: depth by its
# plane (raster_binned._depth), barycentrics by the edge functions taken
# relative to it (raster_binned._interpolate), as the brute path does.

BIG = 4096


def _far_triangles(n, seed, height=BIG, size=5.0):
    """`n` small triangles (`size` texels across, slivers among them) at
    texel coordinates in [2048, 4096) of a BIG x `height` map (rows too
    where the map is that tall), as orthographic clip coordinates (w = 1)
    with depths in (0.2, 0.8)."""
    rng = np.random.default_rng(seed)
    lo_y = 2048 + 8 if height == BIG else 8
    centre = np.concatenate([rng.uniform(2048 + 8, BIG - 8, (n, 1, 1)),
                             rng.uniform(lo_y, height - 8, (n, 1, 1))], -1)
    corners = centre + rng.normal(0.0, size / 2, (n, 3, 2))
    corners[: n // 4, 2] = (corners[: n // 4, 0] + corners[: n // 4, 1]) / 2 + rng.normal(
        0.0, 0.05, (n // 4, 2))  # slivers
    depth = rng.uniform(0.2, 0.8, (n, 1, 1)) + rng.normal(0.0, 0.01, (n, 3, 1))
    ndc_x = corners[..., 0] / BIG * 2.0 - 1.0
    ndc_y = 1.0 - corners[..., 1] / height * 2.0
    clip = np.concatenate([ndc_x[..., None], ndc_y[..., None], depth,
                           np.ones((n, 3, 1))], -1).reshape(-1, 4).astype(np.float32)
    return torch.tensor(clip), torch.arange(3 * n, dtype=torch.int32).reshape(n, 3)


def test_binned_depth_is_exact_at_texel_coordinates_in_the_thousands():
    """K4's plain version on a BIG² map: within 1e-6 of the float64
    interpolation on every texel it covers (the old formula was off by
    ~1e-3 here), the coverage its own, and where the brute path covers the
    same texel the same depth."""
    clip, idx = _far_triangles(3000, 41)
    got = raster.rasterize_depth(clip, idx, BIG, BIG, method="binned")
    exact = raster_binned.depth_exact(clip, idx, BIG, BIG)
    covered = exact < 1.0
    assert int(covered.sum()) > 10000
    assert torch.equal(got < 1.0, covered)
    assert float((got.double() - exact)[covered].abs().max()) <= 1e-6
    brute = raster.rasterize_depth(clip, idx, BIG, BIG, method="brute")
    both = covered & (brute < 1.0)
    assert int(both.sum()) >= 0.99 * int(covered.sum())
    assert float((got - brute)[both].abs().max()) <= 1e-6


@functools.cache
def _sponza_cascades():
    """The Sponza-scale scene's vertices and triangles and its four
    cascades' light view-projections (the default camera and sun)."""
    from rust_renderer_tpu_torch.camera import Camera
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.ops import shadow
    from rust_renderer_tpu_torch.renderer import Renderer

    cam = Camera([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0], fov_degrees=60.0,
                 aspect_ratio=1920 / 1080, z_near=0.01, z_far=1000.0)
    scene = Renderer()
    create_sponza_scale_scene(scene, cam)
    packed = scene.pack_numpy()
    mats, _ = shadow.cascade_matrices(cam.get_view(), cam.get_projection(),
                                      cam.get_near_plane(), cam.get_far_plane(),
                                      np.array([0.0, 0.90631, 0.42262], np.float32))
    return torch.tensor(packed["positions"]), torch.tensor(packed["indices"]), torch.tensor(mats)


def test_binned_depth_of_a_512_cascade_of_the_sponza_scene_is_exact():
    """Cascade 0 of the Sponza-scale scene at 512² (259,932 triangles; the
    old formula left 386 texels beyond 1e-4 here): every covered texel of
    K4's plain version within 1e-5 of the float64 interpolation."""
    positions, indices, mats = _sponza_cascades()
    clip = raster.transform_vertices(positions, mats[0])
    got = raster_binned.rasterize_depth_binned(clip, indices, 512, 512)
    exact = raster_binned.depth_exact(clip, indices, 512, 512)
    covered = exact < 1.0
    assert int(covered.sum()) > 50000
    assert torch.equal(got < 1.0, covered)
    assert float((got.double() - exact)[covered].abs().max()) <= EXACT_ATOL


def test_vis_barycentrics_are_exact_at_texel_coordinates_in_the_thousands():
    """K5's plain version on a BIG x 64 strip of the far triangles (w = 1
    and nothing clipped, so a triangle's barycentrics are its pixel's
    linear ones): depth and (u, v) within 1e-5 of the float64
    interpolation of the triangle it names, on every pixel it covers."""
    clip, idx = _far_triangles(4000, 43, height=64)
    vis = raster.rasterize(clip, idx, BIG, 64, method="binned")
    covered = vis.tri >= 0
    assert int(covered.sum()) > 5000
    py, px = torch.nonzero(covered, as_tuple=True)
    tri = vis.tri[covered].long()
    screen, _ = raster.clip_to_screen(clip, BIG, 64)
    v = screen.double()[idx.long()[tri]]
    (x0, x1, x2), (y0, y1, y2), (z0, z1, z2) = v[..., 0].T, v[..., 1].T, v[..., 2].T
    dx, dy = px.double() + 0.5 - x0, py.double() + 0.5 - y0
    area = (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)
    l1 = (dx * (y2 - y0) - (x2 - x0) * dy) / area
    l2 = ((x1 - x0) * dy - dx * (y1 - y0)) / area
    z = (1.0 - l1 - l2) * z0 + l1 * z1 + l2 * z2
    for got, want in ((vis.depth, z), (vis.bary_u, l1), (vis.bary_v, l2)):
        assert float((got[covered].double() - want).abs().max()) <= EXACT_ATOL
