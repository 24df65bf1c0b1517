"""The rasterized frame, pass by pass: shadow cascades (or, with them off,
ray-traced sun shadows), the g-buffer from primary rays, ray-traced
reflections on metal, SSAO, deferred shading (Cook-Torrance over the sun
and the point lights, image-based ambient, shadows, ambient occlusion),
the sky behind the scene, then sRGB and FXAA.

`Reference` builds the scene, its tree and the environment once, replays
the viewer's camera, and renders a frame for the view it is at. Nothing
here depends on time or on an earlier frame, so a frame is a function of
the camera alone."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from rrt_reference import camera as cam, scene as scenes, shadow, sky
from rrt_reference.trace import Tree

SUN = (0.0, 0.90631, 0.42262)
# The view's toggles and their defaults. The reference renders the
# frame with shadows_enabled and fxaa_enabled either way, and the others
# at their defaults only.
VIEW_FLAGS = {"shadows_enabled": 1, "fxaa_enabled": 1, "ssao_enabled": 1, "cubemap_enabled": 1,
              "ibl_enabled": 1, "sky_enabled": 1, "raytracing_supported": 1,
              "marching_cubes_enabled": 0, "cascade_debug": 0, "fxaa_debug": 0}
_CLEAR = (1.0, 1.0, 1.0, 0.0)


def _unit(a, eps=1e-9):
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=eps)


def _dot(a, b, keepdim=False):
    return (a * b).sum(-1, keepdim=keepdim)


class Reference:
    """The reference renderer of one configuration (its JSON document)."""

    def __init__(self, config: dict, device, size: dict | None = None):
        size = size or {}
        self.width = size.get("width", config["width"])
        self.height = size.get("height", config["height"])
        sc = {"shadow_map_size": 4096, "shadow_cascade_count": 4, "cubemap_size": 512,
              "cubemap_mips": 8, "irradiance_size": 64, "brdf_lut_size": 512,
              **config.get("static_config", {}), **size.get("static_config", {})}
        self.sc = sc
        self.flags = {**VIEW_FLAGS, **config.get("view", {})}
        fixed = {k: v for k, v in self.flags.items()
                 if k not in ("shadows_enabled", "fxaa_enabled") and v != VIEW_FLAGS[k]}
        if config["mode"] != "RASTERIZED" or fixed:
            raise ValueError(f"this reference renders the RASTERIZED frame at the view's "
                             f"defaults but shadows and FXAA, not {config['mode']} {fixed}")
        self.device = torch.device(device)
        self.scene = scenes.build(config["builder"], self.device)
        self.tree = Tree(self.scene.v)
        self.sun = np.asarray(SUN, np.float32)
        env = sky.environment(torch.as_tensor(self.sun, device=self.device), sc["cubemap_size"],
                              sc["cubemap_mips"], sc["irradiance_size"], sc["brdf_lut_size"])
        self.env = env
        self.camera = cam.Camera(self.scene.eye, self.scene.target, self.width / self.height)
        self.input = cam.Input()
        self.store = None  # a control's rounding of every pass's outputs

    # -- the viewer's host side ----------------------------------------------

    def step_camera(self) -> None:
        """One frame of the camera rig under the current input."""
        self.camera.update(self.input)

    def begin_unit(self, unit) -> None:
        """The unit's clock and frame count change nothing: the raster frame
        reads no clock and keeps no state from one frame to the next."""

    @contextlib.contextmanager
    def lower_precision(self, kind: str | None):
        """The frame one precision below float32 with TF32 off: "tf32"
        (TF32 matmuls) or "bf16" (every pass's outputs kept in bfloat16)."""
        if kind is None:
            yield
            return
        if kind == "tf32":
            old = torch.backends.cuda.matmul.allow_tf32
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                yield
            finally:
                torch.backends.cuda.matmul.allow_tf32 = old
            return
        if kind != "bf16":
            raise ValueError(f"unknown control {kind!r}")
        self.store = lambda t: t.to(torch.bfloat16).float() if t.dtype == torch.float32 else t
        try:
            yield
        finally:
            self.store = None

    def _out(self, *tensors):
        if self.store is None:
            return tensors if len(tensors) > 1 else tensors[0]
        out = tuple(self.store(t) for t in tensors)
        return out if len(out) > 1 else out[0]

    # -- the frame ------------------------------------------------------------

    def render(self, state=None) -> dict:
        """{"image": the presented image (H, W, 3)} of the frame at the
        current camera; the frame keeps no state from one to the next, so
        `state` (what the program's frame started from) is not read."""
        dev, h, w = self.device, self.height, self.width
        u = {k: torch.as_tensor(v, device=dev) for k, v in self.camera.uniforms().items()}
        sun = torch.as_tensor(self.sun, device=dev)
        sun_unit = sun / torch.linalg.vector_norm(sun)
        f = self.flags

        mats, splits = shadow.cascades(self.camera.view(), self.camera.projection(),
                                       self.camera.near, self.camera.far, self.sun,
                                       self.sc["shadow_cascade_count"])
        mats_t = torch.as_tensor(mats, device=dev)
        maps = torch.stack([shadow.depth_map(self.scene.v, mats_t[i], self.sc["shadow_map_size"])
                            for i in range(len(mats))]) if f["shadows_enabled"] else None
        maps = self._out(maps) if maps is not None else None

        o, d = self.camera_rays(u)
        hit = self.tree.closest(o.reshape(-1, 3), d.reshape(-1, 3))
        pv = u["projection"] @ u["view"]
        g = self._out(*self.gbuffer(hit, o.reshape(-1, 3), d.reshape(-1, 3), pv))
        g = [x.view(h, w, -1) for x in g]
        gpos, gnorm, galb, gpbr, gdepth = g[0], g[1], g[2], g[3], g[4][..., 0]

        rt_shadows = None
        if not f["shadows_enabled"]:
            rt_shadows = self._out(self.rt_shadows(gpos, gnorm, sun_unit))
        refl = self._out(self.reflections(gpos, gnorm, gpbr, u["eye"], sun_unit))
        occlusion = self._out(ssao(gpos, gnorm, u["view"], u["projection"], 0.3, 0.025))
        color = self._out(self.deferred(gpos, gnorm, galb, gpbr, refl, occlusion, maps, mats_t,
                                        torch.as_tensor(splits, device=dev), u, sun,
                                        rt_shadows))
        color = self._out(self.atmosphere(color, gdepth, d))
        srgb = torch.clamp(color[..., :3], min=0.0)
        srgb = torch.where(srgb < 0.0031308, srgb * 12.92,
                           1.055 * torch.pow(torch.clamp(srgb, min=1e-12), 1.0 / 2.4) - 0.055)
        out = self._out(fxaa(srgb) if f["fxaa_enabled"] else srgb)
        return {"image": out.cpu().numpy()}

    def camera_rays(self, u):
        h, w = self.height, self.width
        dev = self.device
        py = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) + 0.5
        px = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) + 0.5
        dx = (px / w) * 2.0 - 1.0
        dy = (1.0 - py / h) * 2.0 - 1.0
        ip, iv = u["inverse_projection"], u["inverse_view"]
        target = (ip[:3, 0] * dx[..., None] + ip[:3, 1] * dy[..., None] + ip[:3, 2] + ip[:3, 3])
        tw = ip[3, 0] * dx + ip[3, 1] * dy + ip[3, 2] + ip[3, 3]
        target = target / tw[..., None]
        tn = target / torch.linalg.vector_norm(target, dim=-1, keepdim=True)
        direction = tn @ iv[:3, :3].T
        return iv[:3, 3].expand(direction.shape), direction

    def _texture(self, tex_id, uv):
        """Bilinear taps of the scene's textures, mirrored-repeat addressing."""
        tex = self.scene.textures
        s = tex.shape[1]

        def mirror(c):
            m = torch.remainder(c, 2.0 * s)
            m = torch.where(m < 0, m + 2.0 * s, m)
            return torch.clamp(torch.where(m < s, m, 2.0 * s - 1.0 - m), 0.0, s - 1.0)

        fx, fy = mirror(uv[..., 0] * s - 0.5), mirror(uv[..., 1] * s - 0.5)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
        x0, y0 = x0.long(), y0.long()
        x1, y1 = torch.clamp(x0 + 1, max=s - 1), torch.clamp(y0 + 1, max=s - 1)
        flat = tex.reshape(-1, 4)

        def at(y, x):
            return flat[(tex_id * s + y) * s + x].float() / 255.0

        top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
        bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
        return top * (1 - wy) + bot * wy

    def surface(self, hit, o, d):
        """The g-buffer planes (R, 4) x 4 where rays hit: world position,
        normal, albedo, (metallic, roughness, occlusion, material); the
        clear value (1, 1, 1, 0) elsewhere. The scenes carry no tangents, so
        no normal mapping applies."""
        sc = self.scene
        covered = hit.is_hit
        tri = torch.clamp(hit.prim, min=0)
        w1, w2 = hit.u[:, None], hit.v[:, None]
        w0 = 1.0 - hit.u[:, None] - hit.v[:, None]
        nrm = _unit(sc.n[tri, 0] * w0 + sc.n[tri, 1] * w1 + sc.n[tri, 2] * w2)
        uv = sc.uv[tri, 0] * w0 + sc.uv[tri, 1] * w1 + sc.uv[tri, 2] * w2
        material = sc.material[tri]
        diffuse = self._texture(sc.mat_diffuse[material], uv)
        mr = self._texture(torch.full_like(material, 2), uv)
        occ = self._texture(torch.zeros_like(material), uv)
        pos = o + hit.t[:, None] * d
        one = torch.ones_like(hit.t)[:, None]
        clear = torch.tensor(_CLEAR, device=o.device)
        m = covered[:, None]
        return (torch.where(m, torch.cat([pos, one], -1), clear),
                torch.where(m, torch.cat([nrm, one], -1), clear),
                torch.where(m, torch.cat([diffuse[:, :3], one], -1), clear),
                torch.where(m, torch.stack([mr[:, 2], mr[:, 1], occ[:, 0], material.float()], -1),
                            clear))

    def gbuffer(self, hit, o, d, pv):
        p, n, a, pbr = self.surface(hit, o, d)
        pos = o + hit.t[:, None] * d
        clip_z = pos @ pv[2, :3] + pv[2, 3]
        clip_w = pos @ pv[3, :3] + pv[3, 3]
        depth = torch.where(hit.is_hit, clip_z / torch.clamp(clip_w, min=1e-9),
                            torch.ones_like(clip_z))
        return p, n, a, pbr, depth[:, None]

    def rt_shadows(self, gpos, gnorm, sun_unit):
        """(H, W): 1 where the sun is visible from the surface (or the
        pixel is sky), else 0; one ray a pixel from the offset surface."""
        pos = gpos[..., :3].reshape(-1, 3)
        origin = offset_ray(pos, gnorm[..., :3].reshape(-1, 3))
        hit = self.tree.closest(origin, sun_unit.expand(origin.shape), any_hit=True)
        sky_px = (pos == 1.0).all(-1)
        vis = (~hit.is_hit | sky_px).float()
        return vis.view(gpos.shape[:2])

    def reflections(self, gpos, gnorm, gpbr, eye, sun_unit):
        """(H, W, 4): mirror reflections of metal pixels (one bounce, the hit
        shaded by image-based light, a miss by the sky), 0 elsewhere."""
        sc = self.scene
        pos, nrm = gpos[..., :3], gnorm[..., :3]
        material = torch.clamp(gpbr[..., 3].long(), 0, sc.mat_rt_type.shape[0] - 1)
        metal = sc.mat_rt_type[material] == 1
        out = torch.zeros(gpos.shape, device=gpos.device)
        out[..., 3] = 1.0
        idx = torch.nonzero(metal.reshape(-1)).squeeze(1)
        if not idx.numel():
            return out
        p, n = pos.reshape(-1, 3)[idx], nrm.reshape(-1, 3)[idx]
        eye_dir = _unit(p - eye)
        rdir = eye_dir - 2.0 * _dot(eye_dir, n, True) * n
        origin = offset_ray(p, n)
        hit = self.tree.closest(origin, rdir)
        hp, hn, ha, hpbr = self.surface(hit, origin, rdir)
        shaded = self.ibl(hp[:, :3], ha[:, :3], hn[:, :3], hpbr[:, 0], hpbr[:, 1], hpbr[:, 2], eye)
        miss = torch.nonzero(~hit.is_hit).squeeze(1)
        if miss.numel():
            shaded[miss] = sky.sky(origin[miss], rdir[miss], sun_unit)
        out.view(-1, 4)[idx, :3] = shaded
        return out

    def ibl(self, pos, base, n, metallic, roughness, occlusion, eye):
        """Split-sum image-based light."""
        env = self.env
        v = _unit(eye - pos)
        r = -(v - 2.0 * _dot(v, n, True) * n)
        f0 = 0.04 + (base - 0.04) * metallic[..., None]
        ndotv = torch.clamp(_dot(n, v), min=0.0)
        fresnel = f0 + (torch.maximum(1.0 - roughness[..., None], f0) - f0) * torch.pow(
            torch.clamp(1.0 - ndotv, 0.0, 1.0), 5.0)[..., None]
        kd = (1.0 - fresnel) * (1.0 - metallic[..., None])
        diffuse = sky.sample(env["irradiance"], n) * base
        pre = sky.sample_lod(env["specular"], r, roughness * 7.0)
        lut = env["lut"]
        size = lut.shape[0]
        lx = torch.clamp(ndotv * (size - 1), 0, size - 1).long()
        ly = torch.clamp((1.0 - roughness) * (size - 1), 0, size - 1).long()
        ab = lut[ly, lx]
        spec = pre * (fresnel * ab[..., 0:1] + ab[..., 1:2])
        return (kd * diffuse + spec) * occlusion[..., None]

    def deferred(self, gpos, gnorm, galb, gpbr, refl, ssao_t, maps, mats, splits, u, sun,
                 rt_shadows):
        sc, f = self.scene, self.flags
        material = torch.clamp(gpbr[..., 3].long(), 0, sc.mat_roughness.shape[0] - 1)
        roughness = gpbr[..., 1] * sc.mat_roughness[material]
        metallic = gpbr[..., 0] * sc.mat_metallic[material]
        base = torch.pow(torch.clamp(galb[..., :3], min=0.0), 2.2) \
            * sc.mat_base_color[material][..., :3]
        pos, n, occ = gpos[..., :3], gnorm[..., :3], gpbr[..., 2]
        eye = u["eye"]
        lo = shade(pos, base, n, metallic, roughness, eye, None, sun)
        for i in range(sc.num_lights):
            lo = lo + shade(pos, base, n, metallic, roughness, eye, sc.lights[i], None)
        color = self.ibl(pos, base, n, metallic, roughness, occ, eye) + lo
        metal = sc.mat_rt_type[material] == 1
        color = torch.where(metal[..., None], refl[..., :3], color)
        if f["shadows_enabled"]:
            color = color * shadow.lookup(pos, u["view"], maps, mats, splits)[..., None]
        else:
            color = color * torch.clamp(rt_shadows, min=0.3)[..., None]
        color = color * ssao_t[..., None]
        return torch.cat([color, torch.ones_like(color[..., :1])], -1)

    def atmosphere(self, color, depth, d):
        """The sky where no geometry was hit: the captured sky at mip 2."""
        chain = self.env["chain"]
        sky_c = sky.sample(chain[min(2, len(chain) - 1)], d)
        is_sky = (depth >= 1.0)[..., None]
        return torch.where(is_sky, torch.cat([sky_c, torch.ones_like(sky_c[..., :1])], -1), color)


def offset_ray(p, n):
    """A ray origin moved off the surface by a few ulps along n (Ray
    Tracing Gems, chapter 6), or by n / 65536 near the origin."""
    of_i = (256.0 * n).to(torch.int32)
    bits = p.contiguous().view(torch.int32)
    moved = (bits + torch.where(p < 0, -of_i, of_i)).view(torch.float32)
    return torch.where(p.abs() < 1.0 / 32.0, p + (1.0 / 65536.0) * n, moved)


def shade(pos, base, n, metallic, roughness, eye, light_pos, sun_dir):
    """One white light's Cook-Torrance term: the sun (directional, along
    sun_dir mirrored in x and z) or a point light at light_pos
    (attenuation 1 / 0.1 d^2)."""
    v = _unit(eye - pos)
    f0 = 0.04 + (base - 0.04) * metallic[..., None]
    if sun_dir is not None:
        l = _unit(sun_dir * torch.tensor([-1.0, 1.0, -1.0], device=pos.device))
        l = l.expand(pos.shape)
        att = torch.ones_like(metallic)
    else:
        to_light = light_pos - pos
        dist = torch.linalg.vector_norm(to_light, dim=-1)
        l = to_light / torch.clamp(dist, min=1e-9)[..., None]
        att = 1.0 / torch.clamp(0.0 + 0.0 * dist + 0.1 * dist * dist, min=1e-9)
    h = _unit(l + v)
    radiance = att[..., None]
    a2 = (roughness * roughness) ** 2
    ndoth = torch.clamp(_dot(n, h), min=0.0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    ndf = a2 / (sky.PI * denom * denom)
    k = (roughness + 1.0) ** 2 / 8.0
    ndotv = torch.clamp(_dot(n, v), min=0.0)
    ndotl = torch.clamp(_dot(n, l), min=0.0)
    geo = (ndotv / (ndotv * (1.0 - k) + k)) * (ndotl / (ndotl * (1.0 - k) + k))
    fres = f0 + (1.0 - f0) * torch.pow(torch.clamp(1.0 - torch.clamp(_dot(h, v), min=0.0),
                                                   0.0, 1.0), 5.0)[..., None]
    kd = (1.0 - fres) * (1.0 - metallic[..., None])
    spec = (ndf * geo)[..., None] * fres / (4.0 * ndotv * ndotl + 0.0001)[..., None]
    return (kd * base / sky.PI + spec) * radiance * ndotl[..., None]


def _ssao_kernel():
    rng = np.random.default_rng(17)
    v = rng.uniform([-1, -1, 0], [1, 1, 1], (32, 3))
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    v *= rng.uniform(0, 1, (32, 1))
    return (v * (0.1 + 0.9 * (np.arange(32) / 32) ** 2)[:, None]).astype(np.float32)


def _shift(img, dy: int, dx: int):
    """img shifted by (dy, dx), edges clamped."""
    h, w = img.shape[:2]
    rows = torch.clamp(torch.arange(h, device=img.device) + dy, 0, h - 1)
    cols = torch.clamp(torch.arange(w, device=img.device) + dx, 0, w - 1)
    return img[rows][:, cols]


_DIRS, _RINGS = 8, (1, 2, 4, 8, 16, 32)


def ssao(gpos, gnorm, view, proj, radius: float, bias: float):
    """32 hemisphere samples about the view-space normal, each tap snapped
    to the nearest of 8 directions x 6 rings (1 to 32 pixels) of the
    view-depth image, with the smoothstep range check; strength 1.6, sky 1."""
    h, w = gpos.shape[:2]
    pw = gpos[..., :3]
    is_sky = (pw == 1.0).all(-1)
    pv = pw @ view[:3, :3].T + view[:3, 3]
    nv = _unit(gnorm[..., :3] @ torch.linalg.inv(view).T[:3, :3].T)
    rv = torch.tensor([1.0, 1.0, 0.0], device=gpos.device)
    t = _unit(rv - nv * _dot(rv, nv, True))
    b = torch.cross(t, nv, dim=-1)
    vz = pw @ view[2, :3] + view[2, 3]
    planes = []
    for di in range(_DIRS):
        ang = 2.0 * np.pi * di / _DIRS
        for r in _RINGS:
            planes.append(_shift(vz, int(round(np.sin(ang) * r)), int(round(np.cos(ang) * r))))
    planes = torch.stack(planes).view(len(planes), -1)

    def ndc_xy(p):
        clip = p @ proj[:3, :3].T + proj[:3, 3]
        cw = p @ proj[3, :3] + proj[3, 3]
        return clip[..., :2] / torch.clamp(cw.abs(), min=1e-9)[..., None] * torch.sign(cw)[..., None]

    centre = ndc_xy(pv)
    kernel = torch.as_tensor(_ssao_kernel(), device=gpos.device)
    occlusion = torch.zeros((h, w), device=gpos.device)
    flat = torch.arange(h * w, device=gpos.device).view(h, w)
    for i in range(32):
        k = kernel[i]
        sv = (t * k[0] + b * k[1] + nv * k[2]) * radius + pv
        ndc = ndc_xy(sv)
        fx = (ndc[..., 0] - centre[..., 0]) * (0.5 * w)
        fy = (centre[..., 1] - ndc[..., 1]) * (0.5 * h)
        sector = torch.remainder(torch.round(torch.atan2(fy, fx) * (_DIRS / (2.0 * np.pi))).long(),
                                 _DIRS)
        rad = torch.sqrt(fx * fx + fy * fy)
        ring = torch.clamp(torch.round(torch.log2(torch.clamp(rad, min=1e-6)) - 0.0).long(),
                           0, len(_RINGS) - 1)
        tiny = rad < 0.5
        depth = planes[sector * len(_RINGS) + ring, flat]
        denom = torch.clamp((pv[..., 2] - depth).abs(), min=1e-9)
        rc = torch.clamp(radius / denom, 0.0, 1.0)
        rc = rc * rc * (3.0 - 2.0 * rc)
        occluded = (depth >= sv[..., 2] + bias) & ~tiny
        occlusion = occlusion + occluded.float() * rc
    result = 1.0 - (occlusion / 32) * 1.6
    return torch.where(is_sky, torch.ones_like(result), result)


# -- FXAA ---------------------------------------------------------------------

_QUALITY = (1.0, 1.0, 1.0, 1.5, 2.0, 2.0, 2.0, 2.0, 2.0, 2.0, 4.0, 8.0)
_WALK = [1.0]
for _i in range(1, 7):
    _WALK.append(_WALK[-1] + _QUALITY[_i])


def fxaa(color, threshold: float = 0.45):
    """FXAA 3.11 on (H, W, 3) display colour: luma edges against the
    thresholds (0.0312 absolute, 0.125 x threshold relative), the edge's
    direction, a walk of 7 steps to its ends, and the larger of the edge
    offset and the sub-pixel offset (quality 0.75), blended with the
    neighbour across the edge."""
    luma = color[..., 0] * 0.2126 + color[..., 1] * 0.7152 + color[..., 2] * 0.0722
    sh = lambda dy, dx: _shift(luma, dy, dx)
    l_c, l_d, l_u, l_l, l_r = luma, sh(1, 0), sh(-1, 0), sh(0, -1), sh(0, 1)
    l_min = torch.minimum(l_c, torch.minimum(torch.minimum(l_d, l_u), torch.minimum(l_l, l_r)))
    l_max = torch.maximum(l_c, torch.maximum(torch.maximum(l_d, l_u), torch.maximum(l_l, l_r)))
    l_range = l_max - l_min
    no_edge = l_range < torch.clamp(l_max * 0.125 * threshold, min=0.0312)
    l_dl, l_ur, l_ul, l_dr = sh(1, -1), sh(-1, 1), sh(-1, -1), sh(1, 1)
    l_du, l_lr = l_d + l_u, l_l + l_r
    l_left_c, l_down_c, l_right_c, l_up_c = l_dl + l_ul, l_dl + l_dr, l_dr + l_ur, l_ur + l_ul
    edge_h = ((-2.0 * l_l + l_left_c).abs() + (-2.0 * l_c + l_du).abs() * 2.0
              + (-2.0 * l_r + l_right_c).abs())
    edge_v = ((-2.0 * l_u + l_up_c).abs() + (-2.0 * l_c + l_lr).abs() * 2.0
              + (-2.0 * l_d + l_down_c).abs())
    horizontal = edge_h >= edge_v
    l1 = torch.where(horizontal, l_u, l_l)
    l2 = torch.where(horizontal, l_d, l_r)
    g1, g2 = l1 - l_c, l2 - l_c
    steep1 = g1.abs() >= g2.abs()
    g_scaled = 0.25 * torch.maximum(g1.abs(), g2.abs())
    l_avg_local = torch.where(steep1, 0.5 * (l1 + l_c), 0.5 * (l2 + l_c))
    s_pos = ~steep1

    cache = {}

    def probe_int(k: int):
        if k not in cache:
            ph = 0.5 * (sh(0, k) + torch.where(s_pos, sh(1, k), sh(-1, k)))
            pv = 0.5 * (sh(k, 0) + torch.where(s_pos, sh(k, 1), sh(k, -1)))
            cache[k] = torch.where(horizontal, ph, pv)
        return cache[k]

    def probe(dist: float, sign: int):
        if dist == int(dist):
            return probe_int(sign * int(dist))
        lo = int(dist - 0.5)
        return 0.5 * (probe_int(sign * lo) + probe_int(sign * (lo + 1)))

    z = torch.zeros_like(luma)
    reached1 = reached2 = torch.zeros_like(luma, dtype=torch.bool)
    d1, d2, e1_end, e2_end = z, z, z, z
    for dk in _WALK:
        e1 = probe(dk, -1) - l_avg_local
        e2 = probe(dk, +1) - l_avg_local
        d1 = torch.where(reached1, d1, torch.full_like(d1, dk))
        d2 = torch.where(reached2, d2, torch.full_like(d2, dk))
        e1_end = torch.where(reached1, e1_end, e1)
        e2_end = torch.where(reached2, e2_end, e2)
        reached1 = reached1 | (e1.abs() >= g_scaled)
        reached2 = reached2 | (e2.abs() >= g_scaled)
    dir1 = d1 < d2
    offset = -torch.minimum(d1, d2) / torch.clamp(d1 + d2, min=1e-9) + 0.5
    right_way = (torch.where(dir1, e1_end, e2_end) < 0.0) != (l_c < l_avg_local)
    final = torch.where(right_way, offset, torch.zeros_like(offset))
    l_avg = (1.0 / 12.0) * (2.0 * (l_du + l_lr) + l_left_c + l_right_c)
    sub1 = torch.clamp((l_avg - l_c).abs() / torch.clamp(l_range, min=1e-9), 0.0, 1.0)
    sub2 = (-2.0 * sub1 + 3.0) * sub1 * sub1
    final = torch.maximum(final, sub2 * sub2 * 0.75)
    shc = lambda dy, dx: _shift(color, dy, dx)
    s3 = s_pos[..., None]
    neighbour = torch.where(horizontal[..., None], torch.where(s3, shc(1, 0), shc(-1, 0)),
                            torch.where(s3, shc(0, 1), shc(0, -1)))
    f3 = final[..., None]
    aa = (1.0 - f3) * color + f3 * neighbour
    return torch.where((~no_edge)[..., None], aa, color)
