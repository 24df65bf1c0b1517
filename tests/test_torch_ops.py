"""The PyTorch port's frame operations against the JAX package, module by
module, on identical numpy inputs made from seeds.

Tolerances: the random streams (uint32 state and uniform floats) must match
bit for bit; shading math runs op for op in the same order in float32, so
results agree to rtol/atol 1e-5 (transcendentals differ in the last ulps
between XLA and PyTorch); reservoir selections (Y, M) must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu import Camera as JaxCamera
from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu.models import create_scene as jax_create_scene
from rust_renderer_tpu.ops import atmosphere as jatm
from rust_renderer_tpu.ops import colors as jcolors
from rust_renderer_tpu.ops import gbuffer as jgb
from rust_renderer_tpu.ops import intersect as jint
from rust_renderer_tpu.ops import materials as jmat
from rust_renderer_tpu.ops import raster as jraster
from rust_renderer_tpu.ops import rays as jrays
from rust_renderer_tpu.ops import restir as jrestir
from rust_renderer_tpu.ops import rng as jrng
from rust_renderer_tpu.ops import texture as jtex

from rust_renderer_tpu_torch.convert import packed_scene_from_numpy, visibility_from_numpy
from rust_renderer_tpu_torch.ops import atmosphere as tatm
from rust_renderer_tpu_torch.ops import colors as tcolors
from rust_renderer_tpu_torch.ops import gbuffer as tgb
from rust_renderer_tpu_torch.ops import intersect as tint
from rust_renderer_tpu_torch.ops import materials as tmat
from rust_renderer_tpu_torch.ops import rays as trays
from rust_renderer_tpu_torch.ops import restir as trestir
from rust_renderer_tpu_torch.ops import rng as trng
from rust_renderer_tpu_torch.ops import texture as ttex

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
H, W = 16, 24


def T(x):
    """numpy -> CPU tensor (uint32 states become int64)."""
    x = np.asarray(x)
    return torch.tensor(x.astype(np.int64) if x.dtype == np.uint32 else x)


def N(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def scenes():
    jr = JaxRenderer()
    jax_create_scene(jr, JaxCamera([0, 0, 0], [0, 0, -1]))
    jr.ensure_mc_material()
    js = jr.pack()
    fields = {k: np.asarray(getattr(js, k)) for k in js.__dataclass_fields__}
    return js, packed_scene_from_numpy(fields, "cpu")


def _states(seed, shape=(H, W)):
    return np.random.default_rng(seed).integers(0, 2 ** 32, shape, dtype=np.uint32)


def _unit(rng, n):
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def test_rng_streams_bit_equal():
    py, px = np.meshgrid(np.arange(H, dtype=np.int32), np.arange(W, dtype=np.int32),
                         indexing="ij")
    for frame in (0, 7, 2500, -3):
        js = jrng.init_rng(jnp.asarray(px), jnp.asarray(py), W, jnp.int32(frame))
        ts = trng.init_rng(T(px), T(py), W, torch.tensor(frame, dtype=torch.int32))
        np.testing.assert_array_equal(N(ts), np.asarray(js).astype(np.int64))
    js, ts = jnp.asarray(_states(1)), T(_states(1))
    for _ in range(4):
        js, jf = jrng.random_float(js)
        ts, tf = trng.random_float(ts)
        np.testing.assert_array_equal(N(ts), np.asarray(js).astype(np.int64))
        np.testing.assert_array_equal(N(tf).view(np.int32), np.asarray(jf).view(np.int32))
    js, jp = jrng.random_in_unit_sphere_fast(js)
    ts, tp = trng.random_in_unit_sphere_fast(ts)
    np.testing.assert_array_equal(N(ts), np.asarray(js).astype(np.int64))
    np.testing.assert_allclose(N(tp), np.asarray(jp), **TOL)
    js, jv = jrng.random_vec2(js)
    ts, tv = trng.random_vec2(ts)
    np.testing.assert_array_equal(N(tv), np.asarray(jv))


def test_camera_rays_and_offset_ray():
    rng = np.random.default_rng(2)
    cam = JaxCamera([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0], aspect_ratio=W / H)
    iv = np.linalg.inv(cam.get_view()).astype(np.float32)
    ip = np.linalg.inv(cam.get_projection()).astype(np.float32)
    px = rng.uniform(0, W, (H, W)).astype(np.float32)
    py = rng.uniform(0, H, (H, W)).astype(np.float32)
    jo, jd = jrays.generate_camera_rays(iv, ip, px, py, W, H)
    to, td = trays.generate_camera_rays(T(iv), T(ip), T(px), T(py), W, H)
    np.testing.assert_allclose(N(to), np.asarray(jo), **TOL)
    np.testing.assert_allclose(N(td), np.asarray(jd), **TOL)
    p = rng.uniform(-20, 20, (500, 3)).astype(np.float32)
    p[:50] *= 1e-3  # the near-origin branch
    n = _unit(rng, 500)
    np.testing.assert_array_equal(N(trays.offset_ray(T(p), T(n))),
                                  np.asarray(jrays.offset_ray(p, n)))


def test_texture_sampling(scenes):
    js, ts = scenes
    rng = np.random.default_rng(3)
    uv = rng.uniform(-1.5, 2.5, (400, 2)).astype(np.float32)
    tex_id = rng.integers(0, js.textures.shape[0], 400).astype(np.int32)
    for jf, tf in ((jtex.sample_texture_bilinear, ttex.sample_texture_bilinear),
                   (jtex.sample_texture_nearest_mip0, ttex.sample_texture_nearest_mip0)):
        np.testing.assert_allclose(N(tf(ts.textures, T(tex_id), T(uv))),
                                   np.asarray(jf(js.textures, tex_id, uv)), **TOL)


def _hits(js, n, seed):
    """Random triangle hits with valid barycentrics, as a JAX Hit."""
    rng = np.random.default_rng(seed)
    u = rng.uniform(0, 0.5, n).astype(np.float32)
    v = rng.uniform(0, 0.5, n).astype(np.float32)
    return jint.Hit(
        t=rng.uniform(0.5, 20, n).astype(np.float32),
        kind=np.where(rng.uniform(size=n) < 0.85, 1, 0).astype(np.int32),
        prim=rng.integers(0, js.indices.shape[0], n).astype(np.int32),
        u=u, v=v,
    )


def _torch_hit(h):
    return tint.Hit(*(T(np.asarray(x)) for x in h))


def test_surface_at_hit_and_scatter(scenes):
    js, ts = scenes
    n = 600
    rng = np.random.default_rng(4)
    hit = _hits(js, n, 5)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = _unit(rng, n)
    jsurf = jint.surface_at_hit(js, hit, o, d)
    tsurf = tint.surface_at_hit(ts, _torch_hit(hit), T(o), T(d))
    for a, b in zip(tsurf, jsurf):
        np.testing.assert_allclose(N(a), np.asarray(b), **TOL)
    # Every material type of the scene, at one fixed RNG state.
    mats = rng.integers(0, js.mat_rt_type.shape[0], n).astype(np.int32)
    state = _states(6, (n,))
    jst, jsc = jmat.scatter(js, mats, d, np.asarray(jsurf.normal), np.asarray(jsurf.uv),
                            jnp.asarray(state))
    tst, tsc = tmat.scatter(ts, T(mats), T(d), tsurf.normal, tsurf.uv, T(state))
    np.testing.assert_array_equal(N(tst), np.asarray(jst).astype(np.int64))
    for a, b in zip(tsc, jsc):
        np.testing.assert_allclose(N(a), np.asarray(b), **TOL)
    assert set(np.unique(np.asarray(js.mat_rt_type)[mats])) >= {0, 1, 2}


def test_sky_radiance():
    rng = np.random.default_rng(7)
    o = rng.uniform(-10, 10, (300, 3)).astype(np.float32)
    d = _unit(rng, 300)
    sun = np.asarray([0.0, 0.90631, 0.42262], np.float32)
    sun = sun / np.linalg.norm(sun)
    for enabled in (1, 0):
        want = jatm.sky_radiance(o, d, sun, np.int32(enabled))
        got = tatm.sky_radiance(T(o), T(d), T(sun), torch.tensor(enabled, dtype=torch.int32))
        np.testing.assert_allclose(N(got), np.asarray(want), **TOL)


def test_gbuffer_from_rays(scenes):
    js, ts = scenes
    rng = np.random.default_rng(8)
    hit = _hits(js, H * W, 9)
    hit = jint.Hit(*(np.asarray(x).reshape(H, W) for x in hit))
    o = rng.uniform(-8, 8, (H, W, 3)).astype(np.float32)
    d = _unit(rng, H * W).reshape(H, W, 3)
    cam = JaxCamera([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0], aspect_ratio=W / H)
    pv = (cam.get_projection() @ cam.get_view()).astype(np.float32)
    want = jgb.from_rays(js, hit, o, d, projection_view=pv)
    got = tgb.from_rays(ts, _torch_hit(hit), T(o), T(d), projection_view=T(pv))
    for a, b in zip(got, want):
        np.testing.assert_allclose(N(a), np.asarray(b), **TOL)


def test_gbuffer_from_visibility(scenes):
    """A visibility buffer's planes: covered pixels (tri >= 0) shaded at
    their barycentrics, the rest cleared, the depth as given."""
    js, ts = scenes
    hit = _hits(js, H * W, 15)
    rng = np.random.default_rng(16)
    tri = np.where(rng.uniform(size=H * W) < 0.8, np.asarray(hit.prim), -1)
    vis = jraster.VisibilityBuffer(
        depth=rng.uniform(0, 1, (H, W)).astype(np.float32),
        tri=tri.reshape(H, W).astype(np.int32), bary_u=np.asarray(hit.u).reshape(H, W),
        bary_v=np.asarray(hit.v).reshape(H, W))
    want = jgb.from_visibility(js, vis)
    got = tgb.from_visibility(ts, visibility_from_numpy(vis, "cpu"))
    for a, b in zip(got, want):
        np.testing.assert_allclose(N(a), np.asarray(b), **TOL)
    cleared = (N(got.position) == np.float32([1.0, 1.0, 1.0, 0.0])).all(-1)
    np.testing.assert_array_equal(cleared, tri.reshape(H, W) < 0)


def test_any_hit_bruteforce(scenes):
    js, ts = scenes
    rng = np.random.default_rng(17)
    o = rng.uniform(-6, 6, (300, 3)).astype(np.float32)
    d = _unit(rng, 300)
    t_max = rng.uniform(0.5, 30.0, 300).astype(np.float32)
    want = np.asarray(jint.any_hit_bruteforce(js, jnp.asarray(o), jnp.asarray(d), 1e-3,
                                              jnp.asarray(t_max)))
    got = N(tint.any_hit_bruteforce(ts, T(o), T(d), 1e-3, T(t_max)))
    np.testing.assert_array_equal(got, want)
    assert 0 < want.mean() < 1


def test_srgb_to_linear():
    x = np.random.default_rng(18).uniform(-0.1, 1.5, 2000).astype(np.float32)
    x[:4] = (0.0, 0.04045, 0.04044, 1.0)
    np.testing.assert_allclose(N(tcolors.srgb_to_linear(T(x))),
                               np.asarray(jcolors.srgb_to_linear(jnp.asarray(x))), **TOL)


def test_light_intensity_and_resample(scenes):
    """get_light_intensity, and resample with the same rng state in and out."""
    js, ts = scenes
    n_lights = js.light_pos.shape[0]
    rng = np.random.default_rng(19)
    idx = rng.integers(0, n_lights, (H, W)).astype(np.int32)
    dist = rng.uniform(0.0, 20.0, (H, W)).astype(np.float32)
    dist[0, :3] = 0.0  # the 1e-12 clamp
    np.testing.assert_allclose(N(trestir.get_light_intensity(ts, T(idx), T(dist))),
                               np.asarray(jrestir.get_light_intensity(js, idx, dist)), **TOL)
    hp = rng.uniform(-12, 12, (H, W, 3)).astype(np.float32)
    for used in (1024, 3):
        jst, jr = jrestir.resample(js, jnp.asarray(_states(20)), jnp.asarray(hp),
                                   np.int32(n_lights), np.int32(used), 16)
        tst, tr = trestir.resample(ts, T(_states(20)), T(hp),
                                   torch.tensor(n_lights, dtype=torch.int32),
                                   torch.tensor(used, dtype=torch.int32), 16)
        np.testing.assert_array_equal(N(tst), np.asarray(jst).astype(np.int64))
        _assert_reservoirs(tr, jr)
        assert (N(tr.Y) >= 0).all()


def _reservoir(seed, n_lights):
    rng = np.random.default_rng(seed)
    return jrestir.Reservoir(
        Y=rng.integers(-1, n_lights, (H, W)).astype(np.int32),
        W_sum=rng.uniform(0, 2, (H, W)).astype(np.float32),
        W_X=rng.uniform(0, 2, (H, W)).astype(np.float32),
        M=rng.integers(0, 25, (H, W)).astype(np.int32),
    )


def _assert_reservoirs(got, want):
    np.testing.assert_array_equal(N(got.Y), np.asarray(want.Y))
    np.testing.assert_array_equal(N(got.M), np.asarray(want.M))
    np.testing.assert_allclose(N(got.W_sum), np.asarray(want.W_sum), **TOL)
    np.testing.assert_allclose(N(got.W_X), np.asarray(want.W_X), **TOL)


@pytest.mark.parametrize("enabled", [1, 0])
def test_restir_passes(scenes, enabled):
    js, ts = scenes
    n_lights = js.light_pos.shape[0]
    rng = np.random.default_rng(10)
    hp = rng.uniform(-12, 12, (H, W, 3)).astype(np.float32)
    jhp = jnp.asarray(hp)
    nl, mx = np.int32(n_lights), np.int32(1024)
    t_nl, t_mx = torch.tensor(n_lights, dtype=torch.int32), torch.tensor(1024, dtype=torch.int32)
    on = np.int32(enabled)
    t_on = torch.tensor(enabled, dtype=torch.int32)

    jst, jr, jp = jrestir.initial_ris_pass(js, jnp.asarray(_states(11)), jhp, nl, mx, 32,
                                           return_p_hat=True)
    tst, tr, tp = trestir.initial_ris_pass(ts, T(_states(11)), T(hp), t_nl, t_mx, 32,
                                           return_p_hat=True)
    np.testing.assert_array_equal(N(tst), np.asarray(jst).astype(np.int64))
    _assert_reservoirs(tr, jr)
    np.testing.assert_allclose(N(tp), np.asarray(jp), **TOL)

    prev = _reservoir(12, n_lights)
    cam = JaxCamera([-10.28, 2.10, -0.18], [0.0, 0.5, 0.0], aspect_ratio=W / H)
    pv = (cam.get_projection() @ cam.get_view()).astype(np.float32)
    jst, jt, jpt = jrestir.temporal_reuse_pass(
        js, jst, jhp, jr, prev, pv, on, p_hat_initial=jp, return_p_hat=True)
    tst, tt_, tpt = trestir.temporal_reuse_pass(
        ts, tst, T(hp), tr, trestir.Reservoir(*(T(x) for x in prev)), T(pv), t_on,
        p_hat_initial=tp, return_p_hat=True)
    np.testing.assert_array_equal(N(tst), np.asarray(jst).astype(np.int64))
    _assert_reservoirs(tt_, jt)
    np.testing.assert_allclose(N(tpt), np.asarray(jpt), **TOL)

    jst, js_ = jrestir.spatial_reuse_pass(js, jst, jhp, jt, on, 5, 30, p_hat_temporal=jpt)
    tst, ts_ = trestir.spatial_reuse_pass(ts, tst, T(hp), tt_, t_on, 5, 30,
                                          p_hat_temporal=tpt)
    np.testing.assert_array_equal(N(tst), np.asarray(jst).astype(np.int64))
    _assert_reservoirs(ts_, js_)
    # The passes select: not every reservoir stays empty.
    assert (N(ts_.Y) >= 0).mean() > 0.5


def test_select_light_rows_and_uniform_proposal(scenes):
    js, ts = scenes
    n_lights = js.light_pos.shape[0]
    idx = np.random.default_rng(13).integers(0, n_lights, 200).astype(np.int32)
    np.testing.assert_array_equal(N(trestir.select_light_rows(ts, T(idx))),
                                  np.asarray(jrestir.select_light_rows(js, idx)))
    for used in (1024, 3, 0):
        jst, ji, jp = jrestir.sample_light_uniform(jnp.asarray(_states(14)),
                                                   np.int32(n_lights), np.int32(used))
        tst, ti, tp = trestir.sample_light_uniform(
            T(_states(14)), torch.tensor(n_lights, dtype=torch.int32),
            torch.tensor(used, dtype=torch.int32))
        np.testing.assert_array_equal(N(ti), np.asarray(ji))
        np.testing.assert_array_equal(N(tp), np.asarray(jp))
