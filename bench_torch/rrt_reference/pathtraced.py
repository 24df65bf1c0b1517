"""The path-traced frame: the renderer's PATH_TRACED graph with the exact
sky.

A frame is, in order:
- the g-buffer: one closest-hit ray through each pixel's centre; a pixel
  whose ray misses keeps the clear position (1, 1, 1);
- the ReSTIR chain over the point lights, where the scene has any: initial
  RIS over uniform candidates, temporal reuse of the previous frame's
  spatial reservoirs at the backprojected pixel (its M clamped to 20 times
  the new one's), spatial reuse over random neighbours;
- the path tracer: per-pixel PCG streams seeded by the pixel and the frame
  (total_samples + time x 10000, Jenkins hash), jittered pinhole rays, and
  for each bounce the closest hit, the sky on a miss (single scattering,
  clamped to 1), Lambertian, metal or dielectric scattering, then
  next-event estimation toward the sun and one point light (uniform, or
  the reservoir's on the right half of the image where RIS light sampling
  is on), each behind its own occlusion ray;
- the progressive accumulation, restarted at the first sample, and its
  sRGB image.

One departure from the JAX package, which the program makes too: a lane
whose scattered direction is zero or not finite ends there, absorbed.

`Reference` keeps from the check's replay what the program's frames carry
from one to the next: the sample count (restarted when the camera moves)
and the previous frame's projection-view matrix. `render(before)` starts
from the program's state at the unit's start (the accumulation, the
spatial reservoirs) and renders the unit's frames, frame k at
`unit.time(k)`; it returns the last frame's image and the state it leaves,
by the program's names. The path tracer runs in blocks of rows."""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from rrt_reference import camera as cam, rt_materials, scene as scenes, sky, walk
from rrt_reference.raster import offset_ray

SUN = (0.0, 0.90631, 0.42262)
MASK = 0xFFFFFFFF
# The view's settings that the frame reads, at their defaults.
VIEW = {"sky_enabled": 1, "sun_shadow_enabled": 1, "lights_enabled": 1,
        "temporal_reuse_enabled": 1, "spatial_reuse_enabled": 1,
        "use_ris_light_sampling": 0, "max_num_lights_used": 1024,
        "accumulation_limit": 999999, "marching_cubes_enabled": 0}
STATIC = {"samples_per_frame": 1, "num_bounces": 5, "ris_candidates": 32,
          "spatial_neighbors": 5, "spatial_radius": 30, "sky_mode": "exact",
          "furnace_test": False}
# Pixels a block of the path tracer holds (its rays, twice as many NEE
# rays): a 1080p frame is one block, which keeps the walks few.
BLOCK_PIXELS = 1 << 21
RESERVOIR = ("Y", "W_sum", "W_X", "M")


# -- random numbers: uint32 streams held in int64 ---------------------------

def jenkins(x):
    x = x & MASK
    x = (x + (x << 10)) & MASK
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & MASK
    x = x ^ (x >> 11)
    return (x + (x << 15)) & MASK


def seed_pixels(px, py, width: int, frame: int):
    """Each pixel's stream: jenkins((px + py * width) ^ jenkins(frame))."""
    f = jenkins(torch.tensor(frame, dtype=torch.int64, device=px.device))
    return jenkins(((px + py * width) & MASK) ^ f)


def uniform(state):
    """(the state advanced, a float32 in [0, 1]): PCG's output word."""
    state = (state * 747796405 + 1) & MASK
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & MASK
    word = (word >> 22) ^ word
    return state, word.to(torch.float32) / 4294967296.0


def in_unit_ball(state):
    """A point in the unit ball from five floats: a Gaussian direction
    (Box-Muller) scaled by the cube root of the fifth."""
    state, u1 = uniform(state)
    state, u2 = uniform(state)
    state, u3 = uniform(state)
    state, u4 = uniform(state)
    state, u5 = uniform(state)
    r1 = torch.sqrt(-2.0 * torch.log(torch.clamp(u1, min=1e-10)))
    g0 = r1 * torch.cos(2.0 * math.pi * u2)
    g1 = r1 * torch.sin(2.0 * math.pi * u2)
    r2 = torch.sqrt(-2.0 * torch.log(torch.clamp(u3, min=1e-10)))
    g2 = r2 * torch.cos(2.0 * math.pi * u4)
    norm = torch.sqrt(torch.clamp(g0 * g0 + g1 * g1 + g2 * g2, min=1e-20))
    radius = torch.pow(torch.clamp(u5, min=1e-12), 1.0 / 3.0)
    return state, torch.stack([g0, g1, g2], -1) * (radius / norm)[..., None]


# -- vectors ---------------------------------------------------------------

def dot(a, b):
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def unit(v, eps=1e-20):
    return v / torch.clamp(torch.sqrt(dot(v, v)), min=eps)[..., None]


def reflect(d, n):
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(d, n, eta):
    """GLSL refract: zero on total internal reflection."""
    cos_i = -dot(d, n)[..., None]
    eta = eta[..., None]
    k = 1.0 - eta * eta * (1.0 - cos_i * cos_i)
    out = eta * d + (eta * cos_i - torch.sqrt(torch.clamp(k, min=0.0))) * n
    return torch.where(k < 0.0, 0.0, out)


def cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def linear_to_srgb(x):
    return torch.where(x < 0.0031308, x * 12.92,
                       1.055 * torch.pow(torch.clamp(x, min=1e-12), 1.0 / 2.4) - 0.055)


def camera_rays(ip, iv, px, py, width: int, height: int):
    """Pinhole rays through image points (px, py) (pixels, y down):
    (origin, unit direction)."""
    dx = (px / float(width)) * 2.0 - 1.0
    dy = (1.0 - py / float(height)) * 2.0 - 1.0
    target = ip[:3, 0] * dx[..., None] + ip[:3, 1] * dy[..., None] + ip[:3, 2] + ip[:3, 3]
    tw = ip[3, 0] * dx + ip[3, 1] * dy + ip[3, 2] + ip[3, 3]
    target = target / tw[..., None]
    tn = target / torch.sqrt(dot(target, target))[..., None]
    r = iv[:3, :3]
    d = torch.stack([dot(tn, r[0]), dot(tn, r[1]), dot(tn, r[2])], -1)
    return iv[:3, 3].expand(d.shape), d


# -- reservoirs --------------------------------------------------------------

def empty(shape, device) -> dict:
    return {"Y": torch.full(shape, -1, dtype=torch.int32, device=device),
            "W_sum": torch.zeros(shape, device=device),
            "W_X": torch.zeros(shape, device=device),
            "M": torch.zeros(shape, dtype=torch.int32, device=device)}


def pick(cond, a: dict, b: dict) -> dict:
    return {k: torch.where(cond, a[k], b[k]) for k in RESERVOIR}


def update(state, r: dict, y, w, m):
    """Weighted reservoir update: y replaces the sample with probability
    w / W_sum."""
    w_sum = r["W_sum"] + w
    state, u = uniform(state)
    return state, {"Y": torch.where(u * w_sum < w, y, r["Y"]), "W_sum": w_sum,
                   "W_X": r["W_X"], "M": r["M"] + m}


def finalize(r: dict, p_hat) -> dict:
    """W_X = W_sum / (M p_hat), 0 where p_hat is 0."""
    w_x = torch.where(p_hat == 0.0, 0.0, (1.0 / torch.clamp(p_hat, min=1e-20)) * r["W_sum"]
                      / torch.clamp(r["M"], min=1))
    return {**r, "W_X": w_x}


class Reference:
    """The reference renderer of one configuration (its JSON document)."""

    def __init__(self, config: dict, device, size: dict | None = None):
        size = size or {}
        self.width = size.get("width", config["width"])
        self.height = size.get("height", config["height"])
        sc = {**STATIC, **config.get("static_config", {}), **size.get("static_config", {})}
        self.view = {**VIEW, **config.get("view", {})}
        if (config["mode"] != "PATH_TRACED" or sc["sky_mode"] != "exact" or sc["furnace_test"]
                or self.view["marching_cubes_enabled"]):
            raise ValueError("this reference renders the PATH_TRACED frame with the exact sky, "
                             f"no furnace and no isosurface, not {config['mode']} {sc}")
        self.sc = sc
        self.device = torch.device(device)
        self.scene = scenes.build(config["builder"], self.device)
        self.prop = rt_materials.rt_prop(config["builder"], self.scene)
        self.geometry = walk.Scene(self.scene.v)
        self.camera = cam.Camera(self.scene.eye, self.scene.target, self.width / self.height)
        self.input = cam.Input()
        self.samples = 0
        # The previous frame's projection-view: the identity before the first.
        self.prev_pv = np.eye(4, dtype=np.float32)
        self.frames = None
        self.store = None  # a control's rounding of every pass's outputs

    def closest(self, o, d, any_hit=False):
        """The closest hit (some hit where `any_hit`), its (t, u, v) taken
        again on its triangle in the JAX package's order of operations
        (Moller-Trumbore: p = d x e2, q = (o - v0) x e1, each dot product
        left to right), so that a hit position is the same float32 whichever
        walk found the triangle. The temporal reuse's backprojection lands
        on a pixel's edge, so a last-bit change of a primary hit's position
        moves the pixel it reads."""
        hit = self.geometry.query(o, d, any_hit)
        v = self.scene.v[torch.clamp(hit.prim, min=0)]
        e1, e2 = v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]
        p = cross(d, e2)
        inv = 1.0 / dot(e1, p)
        tv = o - v[:, 0]
        q = cross(tv, e1)
        hit.u = torch.where(hit.is_hit, dot(tv, p) * inv, hit.u)
        hit.v = torch.where(hit.is_hit, dot(d, q) * inv, hit.v)
        hit.t = torch.where(hit.is_hit, dot(e2, q) * inv, hit.t)
        return hit

    # -- the viewer's host side ----------------------------------------------

    def step_camera(self) -> None:
        """One frame of the camera rig; a move restarts the accumulation."""
        before = self.camera.pos.copy()
        self.camera.update(self.input)
        turned = self.input.right_mouse_down and self.input.mouse_delta != (0.0, 0.0)
        if turned or bool(np.any(self.camera.pos != before)):
            self.samples = 0

    def begin_unit(self, unit) -> None:
        """Count the unit's samples and hand on its matrices, rendered or
        not: frame k of the unit takes sample count first + k x spf, time
        unit.time(k), and the previous frame's projection-view (this
        unit's own after its first frame)."""
        spf = self.sc["samples_per_frame"]
        u = self.camera.uniforms()
        pv = (u["projection"] @ u["view"]).astype(np.float32)
        self.frames = [(self.samples + (k + 1) * spf, unit.time(k),
                        self.prev_pv if k == 0 else pv) for k in range(unit.frames)]
        self.samples += unit.frames * spf
        self.uniforms = u
        self.prev_pv = pv

    @contextlib.contextmanager
    def lower_precision(self, kind: str | None):
        """The frame one precision below float32 with TF32 off: "tf32"
        (TF32 matmuls; the frame has none) or "bf16" (every pass's float32
        outputs kept in bfloat16)."""
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

    def _out(self, t):
        return t if self.store is None else self.store(t)

    # -- the frame ------------------------------------------------------------

    def render(self, before: dict) -> dict:
        """The unit's frames from `before`, the program's state at its start."""
        dev, h, w = self.device, self.height, self.width
        lights = self.scene.num_lights > 0
        acc = before["accumulation_image"].to(dev, torch.float32)
        spatial = None
        if lights:
            spatial = {k: before[f"spatial_reuse_reservoirs_{k}"].to(dev) for k in RESERVOIR}
            spatial["Y"] = spatial["Y"].to(torch.int32)
            spatial["M"] = spatial["M"].to(torch.int32)
        u = {k: torch.as_tensor(v, device=dev) for k, v in self.uniforms.items()}
        sun = unit(torch.as_tensor(np.asarray(SUN, np.float32), device=dev))
        image = rays = None
        for samples, time, prev_pv in self.frames:
            frame = int(np.int32(np.float32(samples) + np.float32(time) * np.float32(10000.0)))
            py = torch.arange(h, dtype=torch.int64, device=dev)[:, None].expand(h, w)
            px = torch.arange(w, dtype=torch.int64, device=dev)[None, :].expand(h, w)
            base = seed_pixels(px, py, w, frame)
            if lights:
                hit_pos = self._out(self.gbuffer(u))
                spatial = self.restir(base, hit_pos, spatial,
                                      torch.as_tensor(prev_pv, device=dev))
            color = torch.zeros((h, w, 3), device=dev)
            rays = 0
            step = max(1, BLOCK_PIXELS // w)
            for r0 in range(0, h, step):
                res = None if spatial is None else {k: v[r0:r0 + step] for k, v in spatial.items()}
                color[r0:r0 + step], block_rays = self.trace(
                    base[r0:r0 + step], px[r0:r0 + step], py[r0:r0 + step], res, u, sun)
                rays += block_rays
            color = self._out(color)
            # The accumulation restarts at the first sample and stops growing
            # past the limit.
            limit = self.view["accumulation_limit"]
            if samples == self.sc["samples_per_frame"]:
                acc = torch.zeros_like(acc)
            if samples <= limit:
                acc = self._out(acc + color)
            denom = torch.tensor(float(max(min(samples, limit), 1)), device=dev)
            image = self._out(linear_to_srgb(acc / denom))
        # The ray count is a pass output too, float32 in the program.
        rays = self._out(torch.tensor(float(rays), device=dev))
        out = {"image": image.cpu().numpy(), "accumulation_image": acc.cpu().numpy(),
               "pt_rays": float(rays)}
        if lights:
            for k in RESERVOIR:
                out[f"spatial_reuse_reservoirs_{k}"] = spatial[k].float().cpu().numpy()
        return out

    def gbuffer(self, u):
        """(H, W, 3) the primary hits' positions through the pixel centres,
        (1, 1, 1) where the ray misses."""
        h, w, dev = self.height, self.width, self.device
        py = torch.arange(h, dtype=torch.float32, device=dev)[:, None].expand(h, w) + 0.5
        px = torch.arange(w, dtype=torch.float32, device=dev)[None, :].expand(h, w) + 0.5
        o, d = camera_rays(u["inverse_projection"], u["inverse_view"], px, py, w, h)
        o, d = o.reshape(-1, 3), d.reshape(-1, 3)
        hit = self.closest(o.contiguous(), d)
        pos = torch.where(hit.is_hit[:, None], o + hit.t[:, None] * d, 1.0)
        return pos.view(h, w, 3)

    # -- ReSTIR ----------------------------------------------------------------

    def light_rows(self):
        """(L, 6): each light's position and intensity (1, 1, 1)."""
        pos = self.scene.lights
        return torch.cat([pos, torch.ones_like(pos)], 1)

    def target(self, y, hit_pos):
        """p_hat: the luminance of light y's intensity over its squared
        distance from the hit; 0 for no light (y = -1)."""
        rows = self.light_rows()[y.clamp(0, self.scene.num_lights - 1).long()]
        d = rows[..., :3] - hit_pos
        d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
        lum = 0.2126 * rows[..., 3] + 0.7152 * rows[..., 4] + 0.0722 * rows[..., 5]
        return torch.where(y < 0, 0.0, lum / torch.clamp(d2, min=1e-12))

    def uniform_light(self, state):
        """A light drawn uniformly from the first min(L, max used): (state,
        index, pdf)."""
        used = torch.tensor(float(min(self.scene.num_lights, self.view["max_num_lights_used"])),
                            device=state.device)
        state, r = uniform(state)
        idx = torch.minimum((r * used).to(torch.int32), used.to(torch.int32) - 1)
        return state, idx, 1.0 / torch.clamp(used, min=1.0)

    def restir(self, base, hit_pos, prev: dict, prev_pv) -> dict:
        """The chain's three passes; returns the spatial reservoirs."""
        h, w = base.shape
        dev = base.device
        one = torch.ones((h, w), dtype=torch.int32, device=dev)
        # Initial RIS: the candidates' reservoir, its M set to 1, fed through
        # one more reservoir.
        state = base
        res = empty((h, w), dev)
        p_sel = torch.zeros((h, w), device=dev)
        n = self.sc["ris_candidates"]
        for _ in range(n):
            state, cand, pdf = self.uniform_light(state)
            p = self.target(cand, hit_pos)
            state, res = update(state, res, cand, (1.0 / n) * p * (1.0 / pdf), one)
            p_sel = torch.where(res["Y"] == cand, p, p_sel)
        res["M"] = one
        p_sel = torch.where(res["Y"] < 0, 0.0, p_sel)
        res = finalize(res, p_sel)
        res["W_X"] = torch.where(res["Y"] < 0, 0.0, res["W_X"])
        state, init = update(state, empty((h, w), dev), res["Y"],
                             res["W_sum"] * res["M"].float(), res["M"])
        p_init = torch.where(init["Y"] == res["Y"], p_sel, 0.0)
        init = finalize(init, p_init)
        p_init = torch.where(init["Y"] < 0, 0.0, p_init)
        init = {k: self._out(v) for k, v in init.items()}
        p_init = self._out(p_init)

        # Temporal reuse: the previous frame's reservoir at the pixel the hit
        # projected to.
        state = (base * 9781 + 1) & MASK
        state, new = update(state, empty((h, w), dev), init["Y"],
                            p_init * init["W_X"] * init["M"].float(), init["M"])
        m = prev_pv
        hx, hy, hz = hit_pos[..., 0], hit_pos[..., 1], hit_pos[..., 2]

        def row(j):
            return hx * m[j, 0] + hy * m[j, 1] + hz * m[j, 2] + m[j, 3]

        cw = row(3)
        su = (row(0) / cw) * 0.5 + 0.5
        sv = 1.0 - ((row(1) / cw) * 0.5 + 0.5)
        inside = (su >= 0.0) & (su <= 1.0) & (sv >= 0.0) & (sv <= 1.0)
        qx = (su * w + 0.5).to(torch.int32).clamp(0, w - 1).long()
        qy = (sv * h + 0.5).to(torch.int32).clamp(0, h - 1).long()
        old = pick(inside, {k: prev[k][qy, qx] for k in RESERVOIR}, empty((h, w), dev))
        p_old = self.target(old["Y"], hit_pos)
        m_old = torch.minimum(20 * init["M"], old["M"])
        state, new = update(state, new, old["Y"], p_old * old["W_X"] * m_old.float(), m_old)
        p_new = torch.where(new["Y"] < 0, 0.0,
                            torch.where(new["Y"] == init["Y"], p_init, p_old))
        new = finalize(new, p_new)
        new["W_X"] = torch.where(new["Y"] < 0, 0.0, new["W_X"])
        on = self.view["temporal_reuse_enabled"] == 1
        temporal = new if on else init
        p_temp = p_new if on else p_init
        temporal = {k: self._out(v) for k, v in temporal.items()}
        p_temp = self._out(p_temp)

        # Spatial reuse: random neighbours within the radius.
        state = (base * 6271 + 1) & MASK
        state, new = update(state, empty((h, w), dev), temporal["Y"],
                            p_temp * temporal["W_X"] * temporal["M"].float(), temporal["M"])
        p_sel = torch.where(new["Y"] == temporal["Y"], p_temp, 0.0)
        yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
        xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
        radius = self.sc["spatial_radius"]
        for _ in range(self.sc["spatial_neighbors"]):
            state, ox = uniform(state)
            state, oy = uniform(state)
            nx = (xx + ((ox * 2.0 - 1.0) * radius).to(torch.int32)).clamp(0, w - 1).long()
            ny = (yy + ((oy * 2.0 - 1.0) * radius).to(torch.int32)).clamp(0, h - 1).long()
            nb = {k: temporal[k][ny, nx] for k in RESERVOIR}
            p_nb = self.target(nb["Y"], hit_pos)
            state, new = update(state, new, nb["Y"], p_nb * nb["W_X"] * nb["M"].float(), nb["M"])
            p_sel = torch.where(new["Y"] == nb["Y"], p_nb, p_sel)
        new = finalize(new, torch.where(new["Y"] < 0, 0.0, p_sel))
        new["W_X"] = torch.where(new["Y"] < 0, 0.0, new["W_X"])
        out = new if self.view["spatial_reuse_enabled"] == 1 else temporal
        return {k: self._out(v) for k, v in out.items()}

    # -- the path tracer ---------------------------------------------------------

    def texture(self, tex_id, uv):
        """Bilinear taps, mirrored-repeat addressing, the +1 neighbours
        clamped to the edge."""
        tex = self.scene.textures
        s = tex.shape[1]

        def mirror(c):
            m = torch.fmod(c, 2.0 * s)
            m = torch.where(m < 0, m + 2.0 * s, m)
            return torch.clamp(torch.where(m < s, m, 2.0 * s - 1.0 - m), 0.0, s - 1.0)

        fx, fy = mirror(uv[..., 0] * s - 0.5), mirror(uv[..., 1] * s - 0.5)
        x0, y0 = torch.floor(fx), torch.floor(fy)
        wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
        x0, y0 = x0.long(), y0.long()
        x1, y1 = torch.clamp(x0 + 1, max=s - 1), torch.clamp(y0 + 1, max=s - 1)

        def at(y, x):
            return tex[tex_id, y, x].float() / 255.0

        top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
        bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
        return top * (1 - wy) + bot * wy

    def scatter(self, state, hit, d):
        """The hit's scattered ray: (state, the normal turned toward the
        incident ray, the attenuation, the direction, whether it scatters).
        Every lane draws six floats, hit or not."""
        sc = self.scene
        tri = torch.clamp(hit.prim, min=0)
        w0 = (1.0 - hit.u - hit.v)[:, None]
        w1, w2 = hit.u[:, None], hit.v[:, None]
        n = unit(sc.n[tri, 0] * w0 + sc.n[tri, 1] * w1 + sc.n[tri, 2] * w2)
        uv = sc.uv[tri, 0] * w0 + sc.uv[tri, 1] * w1 + sc.uv[tri, 2] * w2
        n = torch.where((dot(n, d) > 0.0)[:, None], -n, n)
        mat = sc.material[tri]
        kind, prop = sc.mat_rt_type[mat], self.prop[mat]
        albedo = self.texture(sc.mat_diffuse[mat], uv)[:, :3] * sc.mat_base_color[mat][:, :3]
        state, ball = in_unit_ball(state)
        state, u_refl = uniform(state)
        dn = unit(d)
        lam = n + ball
        metal = reflect(dn, n) + prop[:, None] * ball
        cos_dn = dot(dn, n)
        outward = torch.where((cos_dn > 0)[:, None], -n, n)
        ratio = torch.where(cos_dn > 0, prop, 1.0 / torch.clamp(prop, min=1e-6))
        cos_t = torch.clamp(dot(-dn, outward), max=1.0)
        sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0
        schlick = r0 + (1.0 - r0) * torch.pow(torch.clamp(1.0 - cos_t, min=0.0), 5.0)
        mirror = (ratio * sin_t > 1.0) | (schlick > u_refl)
        glass = torch.where(mirror[:, None], reflect(dn, outward), refract(dn, outward, ratio))
        k = kind[:, None]
        color = torch.where(k == 0, albedo, 1.0)
        direction = torch.where(k == 0, lam, torch.where(k == 1, metal,
                                                         torch.where(k == 2, glass, 0.0)))
        scattered = torch.where(kind == 0, dot(d, n) < 0.0, kind != 3)
        return state, n, color, direction, scattered

    def trace(self, state, px, py, reservoirs, u, sun):
        """The path tracer over the pixels of a block: ((rows, W, 3) the
        radiance of the frame's samples, the rays traced, as the program
        counts them)."""
        h, w = self.height, self.width
        shape = state.shape
        dev = state.device
        state = state.reshape(-1)
        px, py = px.reshape(-1), py.reshape(-1)
        nl = self.scene.num_lights
        color = torch.zeros(state.shape + (3,), device=dev)
        v = self.view
        rays = 0
        for _ in range(self.sc["samples_per_frame"]):
            state, jx = uniform(state)
            state, jy = uniform(state)
            o, d = camera_rays(u["inverse_projection"], u["inverse_view"],
                               px.float() + jx, py.float() + jy, w, h)
            o = o.contiguous()
            radiance = torch.zeros_like(o)
            through = torch.ones_like(o)
            active = torch.ones(state.shape, dtype=torch.bool, device=dev)
            rays = 0
            for _bounce in range(self.sc["num_bounces"]):
                rays += int((dot(d, d) > 0.0).sum())
                hit = self.closest(o, d)
                missed = ~hit.is_hit
                state, n, hcolor, sdir, scattered = self.scatter(state, hit, d)
                pos = o + hit.t[:, None] * d
                skyc = torch.zeros_like(o)
                idx = torch.nonzero(active & missed).squeeze(1)
                if idx.numel() and v["sky_enabled"] == 1:
                    skyc[idx] = sky.sky(o[idx], unit(d[idx]), sun)
                hcolor = torch.where(missed[:, None], skyc, hcolor)
                through = torch.where(active[:, None], through * hcolor, through)
                done = active & (missed | ~scattered)
                radiance = radiance + torch.where(done[:, None], through, 0.0)
                active = active & ~done
                # The departure the program makes too: a zero or non-finite
                # direction ends the lane, absorbed.
                ended = (sdir == 0.0).all(-1) | ~torch.isfinite(sdir).all(-1)
                active = active & ~ended
                o = torch.where(active[:, None], offset_ray(torch.where(
                    active[:, None], pos, 0.0), n), o)
                d = torch.where(active[:, None], sdir, 0.0)
                state, radiance = self.nee(state, o, through, active, radiance, reservoirs,
                                           px, sun, nl)
                rays += 2 * int(active.sum())
            color = color + radiance
        return color.view(shape + (3,)), rays

    def nee(self, state, o, through, active, radiance, reservoirs, px, sun, nl):
        """The sun, then one point light, each behind an occlusion ray; the
        two fronts walk together, the sun's rays ending at their first hit."""
        v = self.view
        n = o.shape[0]
        state, uni, pdf = self.uniform_light(state)
        sun_on = active & (v["sun_shadow_enabled"] == 1)
        sun_d = torch.where(sun_on[:, None], sun.expand(o.shape), 0.0)
        if nl == 0:
            sun_hit = self.geometry.query(o, sun_d, any_hit=True).is_hit
            return state, radiance + torch.where((sun_on & ~sun_hit)[:, None], through, 0.0)
        use_res = (px > self.width // 2) & (v["use_ris_light_sampling"] == 1)
        uni_w = 1.0 / pdf
        if reservoirs is not None:
            rs = {k: t.reshape(-1) for k, t in reservoirs.items()}
            total = torch.where(use_res, rs["W_sum"], 1.0)
            light = torch.where(use_res, rs["Y"], uni)
            weight = torch.where(use_res, rs["W_X"], uni_w)
        else:
            total = torch.ones_like(through[:, 0])
            light, weight = uni, uni_w.expand(uni.shape)
        valid = (total != 0.0) & (light >= 0)
        rows = self.light_rows()[light.clamp(0, nl - 1).long()]
        to_light = rows[:, :3] - o
        dist = torch.sqrt(dot(to_light, to_light))
        ldir = to_light / torch.clamp(dist, min=1e-12)[:, None]
        light_on = active & valid & (v["lights_enabled"] == 1)
        hit = self.closest(torch.cat([o, o]),
                           torch.cat([sun_d, torch.where(light_on[:, None], ldir, 0.0)]),
                           any_hit=torch.arange(2 * n, device=o.device) < n)
        sun_hit = hit.is_hit[:n]
        blocked = hit.is_hit[n:] & (hit.t[n:] < dist * (1.0 - 1e-4))
        radiance = radiance + torch.where((sun_on & ~sun_hit)[:, None], through, 0.0)
        lum = 0.2126 * rows[:, 3] + 0.7152 * rows[:, 4] + 0.0722 * rows[:, 5]
        p_hat = torch.where(light < 0, 0.0, lum / torch.clamp(dist * dist, min=1e-12))
        contrib = (p_hat * weight)[:, None] * through
        return state, radiance + torch.where((light_on & ~blocked)[:, None], contrib, 0.0)
