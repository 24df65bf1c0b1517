"""Each module of the rasterized frames against its JAX counterpart, on the
same numpy inputs (one parametrised test, one case per module).

Tolerances, and why:
- shadow: cascade matrices to 1e-5 (host numpy, the same code); the PCF
  factor exact but for taps whose depth comparison a last-ulp difference
  flips (at most 0.5% of pixels);
- brdf, pbr, cubemap: 1e-5 relative (elementwise float32, same operation
  order) except the GGX sample directions: brdf.glsl's hash
  fract(sin(x) * 43758.5453) turns a last-ulp difference of sin into ~3e-3
  of the jitter, so sampled directions agree to 1e-3;
- ibl at a 16^2 cubemap: capture and LUT to 1e-4, irradiance to 1e-4 (the
  port sums the samples in batches, another order), specular to 2e-3 (the
  GGX jitter above);
- ssao (both forms), fxaa: their taps snap to pixels, so a rounding
  difference can move a tap: 99.5% of pixels within 1e-5; ssao_blur sums
  the same shifted copies in the same order: 1e-6;
- noise: the value hash is fract(sin(n) * 43758.5453) of n up to ~2e4:
  a last-ulp difference of sin moves one hash by up to ~4e-3 and the
  noise combines eight of them (and fbm five octaves): 2e-2;
- marching cubes at mc_grid 8: positions and normals to 1e-5, slot flags
  and the vertex count equal; its compaction of one result bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_renderer_tpu import Camera as JaxCamera
from rust_renderer_tpu import Renderer as JaxRenderer
from rust_renderer_tpu.ops import brdf as jax_brdf
from rust_renderer_tpu.ops import cubemap as jax_cubemap
from rust_renderer_tpu.ops import fxaa as jax_fxaa
from rust_renderer_tpu.ops import ibl as jax_ibl
from rust_renderer_tpu.ops import marching_cubes as jax_mc
from rust_renderer_tpu.ops import noise as jax_noise
from rust_renderer_tpu.ops import pbr as jax_pbr
from rust_renderer_tpu.ops import shadow as jax_shadow
from rust_renderer_tpu.ops import ssao as jax_ssao
from rust_renderer_tpu.scene import ModelLoader as JaxModelLoader
from rust_renderer_tpu.settings import RenderSettings as JaxRenderSettings

from rust_renderer_tpu_torch import Camera
from rust_renderer_tpu_torch.convert import (
    environment_from_numpy, packed_scene_from_numpy, shadow_cascades_from_numpy,
    view_from_numpy)
from rust_renderer_tpu_torch.ops import (
    brdf, cubemap, fxaa, ibl, marching_cubes, noise, pbr, shadow, ssao)

torch.set_num_threads(1)

SUN = np.array([0.0, 0.90631, 0.42262], np.float32)


def _rng(seed):
    return np.random.default_rng(seed)


def _unit(v):
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def _close(got, want, rtol=1e-5, atol=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def _mostly_close(got, want, atol=1e-5, share=0.995):
    diff = np.abs(got.numpy() - np.asarray(want))
    if diff.ndim == 3:
        diff = diff.max(-1)
    assert (diff <= atol).mean() >= share, (diff <= atol).mean()


def _cameras():
    args = dict(aspect_ratio=1.0, z_near=0.1, z_far=100.0)
    return (JaxCamera([-6.0, 2.0, 1.0], [0.0, 0.5, 0.0], **args),
            Camera([-6.0, 2.0, 1.0], [0.0, 0.5, 0.0], **args))


def _surface(h=48, w=48, seed=0):
    """World positions of a bumpy floor seen by _cameras, and its normals."""
    rng = _rng(seed)
    xs, zs = np.meshgrid(np.linspace(-3, 3, w), np.linspace(-3, 3, h))
    ys = 0.3 * np.sin(2 * xs) * np.cos(3 * zs) + 0.02 * rng.normal(size=xs.shape)
    pos = np.stack([xs, ys, zs], -1).astype(np.float32)
    gy, gx = np.gradient(ys)
    normal = _unit(np.stack([-gx * 10, np.ones_like(ys), -gy * 10], -1))
    pos[:4, :4] = 1.0  # sky pixels: position cleared to (1, 1, 1)
    return pos, normal


def case_shadow():
    jcam, cam = _cameras()
    want_m, want_s = jax_shadow.cascade_matrices(
        jcam.get_view(), jcam.get_projection(), jcam.get_near_plane(), jcam.get_far_plane(), SUN)
    got_m, got_s = shadow.cascade_matrices(
        cam.get_view(), cam.get_projection(), cam.get_near_plane(), cam.get_far_plane(), SUN)
    _close(got_m, want_m)
    _close(got_s, want_s)
    pos, _ = _surface()
    smap = _rng(1).uniform(0.3, 1.0, (4, 64, 64)).astype(np.float32)
    view = jcam.get_view()
    want = jax_shadow.calculate_shadow(jnp.asarray(pos), jnp.asarray(view), jnp.asarray(smap),
                                       jnp.asarray(want_m), jnp.asarray(want_s))
    got = shadow.calculate_shadow(torch.tensor(pos), torch.tensor(view), torch.tensor(smap),
                                  *shadow_cascades_from_numpy(want_m, want_s, "cpu"))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert len(np.unique(np.asarray(want[1]))) > 1  # more than one cascade in view
    _mostly_close(got[0], want[0], atol=1e-6)
    _close(shadow.cascade_debug_color(got[1]), jax_shadow.cascade_debug_color(want[1]))


def case_brdf():
    rng = _rng(2)
    n, v, l = (_unit(rng.normal(size=(500, 3))) for _ in range(3))
    rough = rng.uniform(0.05, 1.0, 500).astype(np.float32)
    f0 = rng.uniform(0.0, 1.0, (500, 3)).astype(np.float32)
    cos = rng.uniform(-0.2, 1.0, 500).astype(np.float32)
    t = lambda a: torch.tensor(a)
    _close(brdf.distribution_ggx(t(n), t(v), t(rough)), jax_brdf.distribution_ggx(n, v, rough))
    _close(brdf.geometry_smith(t(n), t(v), t(l), t(rough)),
           jax_brdf.geometry_smith(n, v, l, rough))
    _close(brdf.fresnel_schlick(t(cos), t(f0)), jax_brdf.fresnel_schlick(cos, f0))
    _close(brdf.fresnel_schlick_roughness(t(cos), t(f0), t(rough)),
           jax_brdf.fresnel_schlick_roughness(cos, f0, rough))
    i = np.arange(1024, dtype=np.int32)
    np.testing.assert_array_equal(brdf.hammersley2d(t(i), 1024).numpy(),
                                  np.asarray(jax_brdf.hammersley2d(jnp.asarray(i), 1024)))
    xi = rng.uniform(0, 1, (500, 2)).astype(np.float32)
    _close(brdf.importance_sample_ggx(t(xi), t(rough), t(n)),
           jax_brdf.importance_sample_ggx(xi, rough, n), rtol=0, atol=1e-3)


def _chain(seed, size=16, levels=4):
    rng = _rng(seed)
    return [rng.uniform(0, 1, (6, size >> m, size >> m, 3)).astype(np.float32)
            for m in range(levels)]


def case_cubemap():
    for f in range(6):
        _close(cubemap.face_directions(f, 8, device="cpu"), jax_cubemap.face_directions(f, 8))
    d = _unit(_rng(3).normal(size=(2000, 3)))
    face, u, v = cubemap.direction_to_face_uv(torch.tensor(d))
    jface, ju, jv = jax_cubemap.direction_to_face_uv(jnp.asarray(d))
    np.testing.assert_array_equal(face.numpy(), np.asarray(jface))
    _close(u, ju)
    _close(v, jv)
    chain = _chain(4)
    _close(cubemap.sample_cubemap(torch.tensor(chain[0]), torch.tensor(d)),
           jax_cubemap.sample_cubemap(jnp.asarray(chain[0]), jnp.asarray(d)))
    lod = _rng(5).uniform(-0.5, 4.0, 2000).astype(np.float32)
    _close(cubemap.sample_cubemap_lod([torch.tensor(c) for c in chain], torch.tensor(d),
                                      torch.tensor(lod)),
           jax_cubemap.sample_cubemap_lod([jnp.asarray(c) for c in chain], jnp.asarray(d),
                                          jnp.asarray(lod)))


def case_ibl():
    want = jax_ibl.capture_environment_cubemap(jnp.asarray(SUN), 16, 4)
    got = ibl.capture_environment_cubemap(torch.tensor(SUN), 16, 4)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        _close(a, b, rtol=1e-4, atol=1e-6)
    chain = [jnp.asarray(c) for c in want]
    tchain = [torch.tensor(np.asarray(c)) for c in want]
    _close(ibl.irradiance_convolution(tchain[2], 8),
           jax_ibl.irradiance_convolution(chain[2], 8), rtol=1e-4, atol=1e-6)
    for a, b in zip(ibl.specular_prefilter(tchain, 4), jax_ibl.specular_prefilter(chain, 4)):
        _close(a, b, rtol=0, atol=2e-3)
    _assert_lut_close(ibl.brdf_lut(16, 64, device="cpu"), jax_ibl.brdf_lut(16, 64), 64)


LUT_SIZE, LUT_SAMPLES = 16, 64


def _lut_setup(size: int, num_samples: int):
    """The LUT's rows' roughness, its columns' NdotV, and per sample the
    Hammersley point and the GGX phi as ops/ibl.py::brdf_lut makes them
    (float32), as float64 arrays."""
    xi = brdf.hammersley2d(torch.arange(num_samples), num_samples).double().numpy()
    jitter = brdf._glsl_random(torch.zeros(()), torch.ones(())) * 0.1
    phi = (2.0 * brdf.PI * torch.tensor(xi[:, 0], dtype=torch.float32) + jitter).double()
    grid = (np.arange(size) + 0.5) / size
    return grid.astype(np.float32).astype(np.float64), grid, xi, phi.numpy()


def _cos_theta64(rough, xi1):
    """importance_sample_ggx's cos_theta in float64, (rows, samples)."""
    a2 = (rough ** 2)[:, None] ** 2
    return np.sqrt((1.0 - xi1[None]) / (1.0 + (a2 - 1.0) * xi1[None]))


def _lut_terms64(cos_t, phi, rough, nv):
    """brdf_lut's two summands ((1 - Fc) G_vis, Fc G_vis) of one sample in
    float64, for cos_theta `cos_t` and phi `phi` at roughness `rough`, over
    the columns' NdotV `nv`."""
    sin_t = np.sqrt(max(1.0 - cos_t * cos_t, 0.0))
    n, up = np.array([0.0, 0.0, 1.0]), np.array([1.0, 0.0, 0.0])
    tx = np.cross(up, n)
    ty = np.cross(n, tx)
    h = tx * sin_t * np.cos(phi) + ty * sin_t * np.sin(phi) + n * cos_t
    h = h / np.linalg.norm(h)
    v = np.stack([np.sqrt(1.0 - nv * nv), np.zeros_like(nv), nv], -1)
    vdh = v @ h
    l = 2.0 * vdh[:, None] * h - v
    ndotl, ndoth, vdoth = np.clip(l[:, 2], 0, 1), np.clip(h[2], 0, 1), np.clip(vdh, 0, 1)
    k = rough * rough / 2.0
    g1v, g1l = nv / (nv * (1 - k) + k), ndotl / (ndotl * (1 - k) + k)
    g_vis = g1v * g1l * vdoth / np.maximum(ndoth * nv, 1e-6)
    fc = (1.0 - vdoth) ** 5
    return np.stack([np.where(ndotl > 0, (1 - fc) * g_vis, 0.0),
                     np.where(ndotl > 0, fc * g_vis, 0.0)], -1)


def _lut_conditioning(size: int, num_samples: int) -> np.ndarray:
    """(size, size, 2): how far each LUT entry may move with the float32
    rounding of cos_theta where that rounding is ill-conditioned.

    importance_sample_ggx computes cos_theta = sqrt((1 - xi2) / (1 + (a^2 -
    1) xi2)) and sin_theta = sqrt(1 - cos_theta^2). Where cos_theta lies
    within 2 float32 ulp (2^-23) of 1, one ulp (2^-24) moves sin_theta by up
    to sqrt(2 * 2^-24) = 3.45e-4, against ~1e-7 elsewhere: the half vector h
    turns by that much, and two correct float32 evaluations (this port's
    rounds to the nearest float32, XLA's CPU code may land one ulp lower)
    give different h. The sample's summand (1 - Fc) G_vis (and Fc G_vis)
    then moves by its spread over the float32 values of cos_theta within 2
    ulp of the float64 value, weighted like every sample by 1 / num_samples.
    That spread, computed here in float64 with the LUT's own arithmetic, is
    the bound such an entry is held to beyond the 1e-4 tolerance; the
    entries of rows with no such sample get 0. Sample 0 (xi2 = 0) gives
    cos_theta exactly 1 in any IEEE evaluation and is not counted."""
    rough, nv, xi, phi = _lut_setup(size, num_samples)
    cos64 = _cos_theta64(rough, xi[:, 1])
    bound = np.zeros((size, size, 2))
    for row, s in zip(*np.nonzero((1.0 - cos64 <= 2.0 ** -23) & (cos64 < 1.0))):
        ulps = np.float32(1.0) - np.arange(3, dtype=np.float32) * np.float32(2.0 ** -24)
        near = [float(c) for c in ulps if abs(float(c) - cos64[row, s]) <= 2.0 ** -23]
        terms = np.stack([_lut_terms64(c, phi[s], rough[row], nv) for c in near])
        bound[row] += (terms.max(0) - terms.min(0)) / num_samples
    return bound


def _assert_lut_close(got, want, num_samples: int) -> None:
    """The LUT within rtol 1e-4 / atol 1e-5, plus `_lut_conditioning` on the
    entries whose samples round ill-conditioned."""
    got, want = got.numpy(), np.asarray(want)
    extra = _lut_conditioning(got.shape[0], num_samples)
    assert set(np.nonzero(extra.max(axis=(1, 2)))[0]) <= {0}  # only roughness 1/32
    np.testing.assert_array_less(np.abs(got - want), 1e-5 + 1e-4 * np.abs(want) + extra)


def test_brdf_lut_sample_near_the_normal_rounds_correctly():
    """The cause of the LUT's ill-conditioned entries: at roughness 1/32
    (row 0 of a 16-entry LUT) and Hammersley sample 48 of 64, cos_theta is
    0.99999998 in float64. The port's is its correctly rounded float32
    (1.0, so h is the normal itself); the JAX package's is at most one ulp
    away."""
    rough, _, xi, _ = _lut_setup(LUT_SIZE, LUT_SAMPLES)
    cos64 = _cos_theta64(rough[:1], xi[48:49, 1])[0, 0]
    assert 1.0 - 2.0 ** -24 < cos64 < 1.0
    n = torch.tensor([0.0, 0.0, 1.0])
    xi32 = brdf.hammersley2d(torch.tensor([48]), LUT_SAMPLES)
    h = brdf.importance_sample_ggx(xi32, torch.tensor([1.0 / 32.0]), n[None])[0].numpy()
    assert h[2] == np.float32(cos64) == 1.0
    assert np.all(h[:2] == 0.0)
    jh = np.asarray(jax_brdf.importance_sample_ggx(jnp.asarray(xi32.numpy()),
                                                   jnp.asarray([1.0 / 32.0], jnp.float32),
                                                   jnp.asarray(n.numpy())[None]))[0]
    assert abs(float(jh[2]) - float(np.float32(cos64))) <= 2.0 ** -24


def _lit_scene():
    r = JaxRenderer()
    r.add_model(JaxModelLoader.load_cube(), np.eye(4, dtype=np.float32))
    r.add_light([2.0, 3.0, 2.0], [1.0, 0.8, 0.6], 1.0)
    r.add_light([-2.0, 1.0, 0.5], [0.3, 0.5, 1.0], 2.0)
    r.add_light([0.0, 5.0, -1.0], [1.0, 1.0, 1.0], 1.0)
    scene = r.pack()
    port = packed_scene_from_numpy({k: np.asarray(getattr(scene, k))
                                    for k in scene.__dataclass_fields__}, "cpu")
    return scene, port


def _pixels(seed, shape=(24, 24)):
    rng = _rng(seed)
    fields = dict(
        position=rng.uniform(-2, 2, shape + (3,)), base_color=rng.uniform(0, 1, shape + (3,)),
        normal=_unit(rng.normal(size=shape + (3,))), metallic=rng.uniform(0, 1, shape),
        roughness=rng.uniform(0.05, 1, shape), occlusion=rng.uniform(0.5, 1, shape))
    fields = {k: np.asarray(v, np.float32) for k, v in fields.items()}
    return (jax_pbr.PixelParams(**{k: jnp.asarray(v) for k, v in fields.items()}),
            pbr.PixelParams(**{k: torch.tensor(v) for k, v in fields.items()}))


def case_pbr():
    scene, port = _lit_scene()
    jcam, _ = _cameras()
    view = JaxRenderSettings.default(sun_dir=SUN, num_lights=2).with_camera(jcam, 24, 24)
    jpix, tpix = _pixels(6)
    _close(pbr.shade_all_lights(tpix, port, view_from_numpy(vars(view), "cpu")),
           jax_pbr.shade_all_lights(jpix, scene, view), rtol=1e-4, atol=1e-6)
    env = {"irradiance_map": _chain(7, 8, 1)[0],
           "brdf_lut": _rng(9).uniform(0, 1, (16, 16, 2)).astype(np.float32)}
    env.update({f"specular_map_mip{m}": c for m, c in enumerate(_chain(8, 16, 5))})
    port_env = environment_from_numpy(env, "cpu")
    spec = [f"specular_map_mip{m}" for m in range(5)]
    eye = np.asarray(view.eye_pos)
    _close(pbr.image_based_lighting(tpix, torch.tensor(eye), port_env["irradiance_map"],
                                    [port_env[k] for k in spec], port_env["brdf_lut"], 4.0),
           jax_pbr.image_based_lighting(jpix, eye, env["irradiance_map"],
                                        [jnp.asarray(env[k]) for k in spec], env["brdf_lut"],
                                        4.0),
           rtol=1e-4, atol=1e-6)


def case_ssao():
    jcam, _ = _cameras()
    pos, normal = _surface()
    pad = lambda a: np.concatenate([a, np.ones_like(a[..., :1])], -1)
    args = [pad(pos), pad(normal), jcam.get_view(), jcam.get_projection()]
    want = jax_ssao.ssao_stencil(*(jnp.asarray(a) for a in args), jnp.float32(0.3),
                                 jnp.float32(0.025))
    got = ssao.ssao_stencil(*(torch.tensor(a) for a in args), 0.3, 0.025)
    assert float(np.asarray(want).min()) < 0.95  # some occlusion
    _mostly_close(got, want)


def case_ssao_exact():
    jcam, _ = _cameras()
    pos, normal = _surface()
    pad = lambda a: np.concatenate([a, np.ones_like(a[..., :1])], -1)
    args = [pad(pos), pad(normal), jcam.get_view(), jcam.get_projection()]
    want = jax_ssao.ssao(*(jnp.asarray(a) for a in args), jnp.float32(0.3), jnp.float32(0.025))
    got = ssao.ssao(*(torch.tensor(a) for a in args), 0.3, 0.025)
    assert float(np.asarray(want).min()) < 0.95  # some occlusion
    _mostly_close(got, want)
    occ = _rng(21).uniform(0, 1, (24, 40)).astype(np.float32)
    for radius in (1, 2):
        _close(ssao.ssao_blur(torch.tensor(occ), radius),
               jax_ssao.ssao_blur(jnp.asarray(occ), radius), rtol=1e-6, atol=1e-6)


def case_fxaa():
    rng = _rng(10)
    img = np.kron(rng.uniform(0, 1, (12, 12, 3)), np.ones((4, 4, 1))).astype(np.float32)
    img = img + 0.05 * rng.normal(size=img.shape).astype(np.float32)
    for enabled, debug in ((1, 0), (1, 1), (0, 0)):
        want = jax_fxaa.fxaa(jnp.asarray(img), 0.45, enabled, debug)
        got = fxaa.fxaa(torch.tensor(img), 0.45, enabled, debug)
        _mostly_close(got, want)
    assert np.abs(np.asarray(jax_fxaa.fxaa(jnp.asarray(img))) - img).max() > 0.01


def case_noise():
    x = _rng(11).uniform(-4, 4, (300, 3)).astype(np.float32)
    _close(noise.noised(torch.tensor(x)), jax_noise.noised(jnp.asarray(x)), rtol=0, atol=2e-2)
    _close(noise.fbm(torch.tensor(x)), jax_noise.fbm(jnp.asarray(x)), rtol=0, atol=2e-2)


def case_marching_cubes():
    for time in (0.0, 2.5):
        want = jax_mc.marching_cubes(grid=8, voxel_size=4.0, time=time)
        got = marching_cubes.marching_cubes(grid=8, voxel_size=4.0, time=time, device="cpu")
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
        assert int(got.vertex_count) == int(want.vertex_count) > 0
        _close(got.positions, want.positions)
        _close(got.normals, want.normals, rtol=1e-4, atol=1e-5)
    res = marching_cubes.MarchingCubesResult(
        *(torch.tensor(np.asarray(x)) for x in (want.positions, want.normals, want.valid)),
        vertex_count=torch.tensor(int(want.vertex_count)))
    n_valid = int(np.asarray(want.valid).sum())
    for capacity in (n_valid + 7, n_valid // 2):  # room to spare, and overflow
        for a, b in zip(marching_cubes.compact(res, capacity), jax_mc.compact(want, capacity)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


CASES = {name[5:]: fn for name, fn in globals().items() if name.startswith("case_")}


@pytest.mark.parametrize("module", sorted(CASES))
def test_module_matches_jax(module):
    CASES[module]()
