"""The sky and the image-based lighting made from it.

The sky is single scattering in a Rayleigh, Mie and ozone atmosphere over
a planet of radius 6371 km (100 km of atmosphere, 16 samples along the
view ray spaced by a power of the height, 8 toward the sun, exposure 20),
clamped to 1. A cubemap is six faces (+X, -X, +Y, -Y, +Z, -Z) sampled
bilinearly within the face, edges clamped; its mip chain halves by 2 x 2
means. From the captured sky come the cosine-weighted irradiance map
(steps of 0.025 rad), the GGX-prefiltered specular chain (32 Hammersley
samples, roughness m / (mips - 1) at mip m) and the split-sum BRDF table."""

from __future__ import annotations

import math

import torch

PI = 3.14159265359
_R, _H = 6371000.0, 100000.0
_RAYLEIGH_H, _MIE_H = _H * 0.08, _H * 0.012
_C_RAYLEIGH = (5.802e-6, 13.558e-6, 33.100e-6)
_C_MIE = (3.996e-6, 3.996e-6, 3.996e-6)
_C_OZONE = (0.650e-6, 1.881e-6, 0.085e-6)


def _vec(values, like):
    return torch.tensor(values, dtype=torch.float32, device=like.device)


def _sphere(start, d, radius):
    rs = start - _vec([0.0, -_R, 0.0], start)
    a = (d * d).sum(-1)
    b = 2.0 * (rs * d).sum(-1)
    c = (rs * rs).sum(-1) - radius * radius
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    miss = disc < 0
    t0, t1 = (-b - sq) / (2 * a), (-b + sq) / (2 * a)
    return torch.where(miss, -1.0, t0), torch.where(miss, -1.0, t1)


def _height(p):
    return torch.linalg.vector_norm(p - _vec([0.0, -_R, 0.0], p), dim=-1) - _R


def _density(h):
    hp = torch.clamp(h, min=0.0)
    return torch.stack([torch.exp(-hp / _RAYLEIGH_H), torch.exp(-hp / _MIE_H),
                        torch.clamp(1.0 - (h - 25000.0).abs() / 15000.0, min=0.0)], -1)


def _absorb(od):
    return torch.exp(-(od[..., 0:1] * _vec(_C_RAYLEIGH, od)
                       + od[..., 1:2] * _vec(_C_MIE, od) * 1.1
                       + od[..., 2:3] * _vec(_C_OZONE, od)))


def scattering(start, d, sun):
    """The sky's colour along rays (..., 3) from `start` toward `d`, the
    sun along `sun` (3,), before the clamp."""
    exponent = 1.0 + torch.clamp(1.0 - _height(start) / _H, 0.0, 1.0) * 8.0
    t0, t1 = _sphere(start, d, _R + _H)
    length = torch.clamp(t1, max=999999999.0)
    entered = t0 > 0
    start = torch.where(entered[..., None], start + d * torch.clamp(t0, min=0.0)[..., None], start)
    length = torch.where(entered, length - torch.clamp(t0, min=0.0), length)
    cos = (d * sun).sum(-1)
    phase_r = 3.0 * (1.0 + cos * cos) / (16.0 * math.pi)
    g = 0.85
    k = 1.55 * g - 0.55 * g * g * g
    phase_m = (1.0 - k * k) / ((4.0 * math.pi) * (1.0 - k * cos) * (1.0 - k * cos))
    od = torch.zeros(d.shape, device=d.device)
    rayleigh = torch.zeros_like(od)
    mie = torch.zeros_like(od)
    prev = torch.zeros_like(length)
    sun_b = sun.expand(d.shape)
    for i in range(16):
        time = torch.pow(torch.tensor(i / 16, device=d.device), exponent) * length
        step = time - prev
        pos = start + d * time[..., None]
        dens = _density(_height(pos))
        od = od + dens * step[..., None]
        view_t = _absorb(od)
        _, s1 = _sphere(pos, sun_b, _R + _H)
        light_od = torch.zeros_like(od)
        sstep = s1 / 8
        for j in range(8):
            p = pos + sun_b * ((j + 0.5) * sstep)[..., None]
            light_od = light_od + _density(_height(p)) * sstep[..., None]
        common = view_t * _absorb(light_od) * step[..., None]
        rayleigh = rayleigh + common * (phase_r * dens[..., 0])[..., None]
        mie = mie + common * (phase_m * dens[..., 1])[..., None]
        prev = time
    return (rayleigh * _vec(_C_RAYLEIGH, d) + mie * _vec(_C_MIE, d)) * 20.0


def sky(start, d, sun):
    return torch.clamp(scattering(start, d, sun), max=1.0)


# -- cubemaps -----------------------------------------------------------------

_FORWARD = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]]
_RIGHT = [[0, 0, -1], [0, 0, 1], [1, 0, 0], [1, 0, 0], [1, 0, 0], [-1, 0, 0]]
_UP = [[0, -1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1], [0, -1, 0], [0, -1, 0]]


def face_directions(size: int, device) -> torch.Tensor:
    """(6, S, S, 3) unit directions through the texel centres."""
    ts = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size * 2.0 - 1.0
    v, u = torch.meshgrid(ts, ts, indexing="ij")
    f = torch.tensor(_FORWARD, dtype=torch.float32, device=device)[:, None, None]
    r = torch.tensor(_RIGHT, dtype=torch.float32, device=device)[:, None, None]
    up = torch.tensor(_UP, dtype=torch.float32, device=device)[:, None, None]
    d = f + u[..., None] * r + v[..., None] * up
    return d / torch.linalg.vector_norm(d, dim=-1, keepdim=True)


def _face_uv(d):
    x, y, z = d.unbind(-1)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = (ay > ax) & (ay >= az)
    face = torch.where(is_x, torch.where(x > 0, 0, 1),
                       torch.where(is_y, torch.where(y > 0, 2, 3), torch.where(z > 0, 4, 5)))
    major = torch.clamp(torch.where(is_x, ax, torch.where(is_y, ay, az)), min=1e-12)
    u = torch.where(is_x, torch.where(x > 0, -z, z),
                    torch.where(is_y, x, torch.where(z > 0, x, -x)))
    v = torch.where(is_x, -y, torch.where(is_y, torch.where(y > 0, z, -z), -y))
    return face, (u / major) * 0.5 + 0.5, (v / major) * 0.5 + 0.5


def _bilinear(flat, c, face, u, v, size, offset=0):
    """Bilinear taps of faces stored flat (rows of c values) from `offset`,
    `size` texels a side (a number or a tensor)."""
    if not torch.is_tensor(size):
        size = torch.tensor(float(size), device=u.device)
    fx = torch.minimum(torch.clamp(u * size - 0.5, min=0.0), size - 1.0)
    fy = torch.minimum(torch.clamp(v * size - 0.5, min=0.0), size - 1.0)
    x0, y0 = torch.floor(fx), torch.floor(fy)
    wx, wy = (fx - x0)[..., None], (fy - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    s = size.long()
    x1, y1 = torch.minimum(x0 + 1, s - 1), torch.minimum(y0 + 1, s - 1)
    base = offset + face * s * s

    def at(y, x):
        return flat[base + y * s + x]

    top = at(y0, x0) * (1 - wx) + at(y0, x1) * wx
    bot = at(y1, x0) * (1 - wx) + at(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def sample(cube, d):
    """Bilinear sample of a (6, S, S, C) cubemap along d (..., 3)."""
    face, u, v = _face_uv(d)
    return _bilinear(cube.reshape(-1, cube.shape[-1]), cube.shape[-1], face, u, v, cube.shape[1])


def sample_lod(chain, d, lod):
    """Trilinear sample of a mip chain at level `lod` (...,)."""
    n = len(chain)
    lod = torch.clamp(lod, 0.0, n - 1)
    lo = torch.floor(lod).long()
    hi = torch.clamp(lo + 1, max=n - 1)
    frac = (lod - lo.float())[..., None]
    face, u, v = _face_uv(d)
    flat = torch.cat([c.reshape(-1, c.shape[-1]) for c in chain])
    sizes = torch.tensor([c.shape[1] for c in chain], device=d.device)
    offsets = torch.cumsum(6 * sizes * sizes, 0) - 6 * sizes * sizes
    c = chain[0].shape[-1]
    out_lo = _bilinear(flat, c, face, u, v, sizes[lo].float(), offsets[lo])
    out_hi = _bilinear(flat, c, face, u, v, sizes[hi].float(), offsets[hi])
    return out_lo * (1 - frac) + out_hi * frac


# -- image-based lighting -----------------------------------------------------

def _hammersley(i: torch.Tensor, n: int) -> torch.Tensor:
    bits = i.long() & 0xFFFFFFFF
    bits = ((bits << 16) | (bits >> 16)) & 0xFFFFFFFF
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        bits = ((bits & mask) << shift) | ((bits & (mask << shift)) >> shift)
    rdi = bits.float() * 2.3283064365386963e-10
    return torch.stack([i.float() / n, rdi], -1)


def _glsl_random(x, z):
    dt = x * 12.9898 + z * 78.233
    return torch.remainder(torch.sin(torch.remainder(dt, 3.14)) * 43758.5453, 1.0)


def _cross(a, b):
    return torch.cross(a, b, dim=-1)


def _unit(a, eps):
    return a / torch.clamp(torch.linalg.vector_norm(a, dim=-1, keepdim=True), min=eps)


def ggx_half_vector(xi, roughness, n):
    """A GGX-distributed half vector about n (with the shader's small
    random turn of phi)."""
    alpha = roughness * roughness
    phi = 2.0 * PI * xi[..., 0] + _glsl_random(n[..., 0], n[..., 2]) * 0.1
    cos_t = torch.sqrt((1.0 - xi[..., 1]) / (1.0 + (alpha * alpha - 1.0) * xi[..., 1]))
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    h = torch.stack([sin_t * torch.cos(phi), sin_t * torch.sin(phi), cos_t], -1)
    z_up = (n[..., 2].abs() < 0.999)[..., None]
    up = torch.where(z_up, _vec([0.0, 0.0, 1.0], n).expand(n.shape),
                     _vec([1.0, 0.0, 0.0], n).expand(n.shape))
    tx = _unit(_cross(up, n), 1e-12)
    ty = _unit(_cross(n, tx), 1e-12)
    return _unit(tx * h[..., 0:1] + ty * h[..., 1:2] + n * h[..., 2:3], 1e-12)


def environment(sun, size: int, mips: int, irradiance_size: int, lut_size: int,
                lut_samples: int = 256) -> dict:
    """The captured sky's mip chain, the irradiance map, the specular chain
    and the BRDF table."""
    dev = sun.device
    dirs = face_directions(size, dev)
    level = sky(_vec([0.0, 1.0, 0.0], sun).expand(dirs.shape), dirs, sun)
    chain = [level]
    for _ in range(1, mips):
        s = chain[-1].shape[1] // 2
        if s < 1:
            break
        chain.append(chain[-1].reshape(6, s, 2, s, 2, 3).mean(dim=(2, 4)))

    # Irradiance: cosine-weighted over the hemisphere about each texel.
    src = chain[min(2, len(chain) - 1)]
    n = face_directions(irradiance_size, dev)
    right = _cross(_vec([0.0, 1.0, 0.0], n).expand(n.shape), n)
    rn = torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    right = torch.where(rn > 1e-4, right / torch.clamp(rn, min=1e-9),
                        _vec([1.0, 0.0, 0.0], n).expand(n.shape))
    up = _cross(n, right)
    delta = 0.025
    n_phi, n_theta = int(2.0 * PI / delta), int(0.5 * PI / delta)
    total = torch.zeros(n.shape, device=dev)
    wsum = torch.zeros((), device=dev)
    idx = torch.arange(n_phi * n_theta, device=dev)
    for chunk in idx.split(64):
        phi = (chunk // n_theta).float() * delta
        theta = (chunk % n_theta).float() * delta
        tx = torch.sin(theta) * torch.cos(phi)
        ty = torch.sin(theta) * torch.sin(phi)
        tz = torch.cos(theta)
        d = (right[..., None, :] * tx[:, None] + up[..., None, :] * ty[:, None]
             + n[..., None, :] * tz[:, None])
        w = torch.cos(theta) * torch.sin(theta)
        total = total + (sample(src, d) * w[:, None]).sum(-2)
        wsum = wsum + w.sum()
    irradiance = total / torch.clamp(wsum, min=1e-9)

    # Specular: GGX-importance filtered, roughness rising with the mip.
    specular = []
    for m in range(min(mips, len(chain))):
        rough = m / max(mips - 1, 1)
        if rough == 0.0:
            specular.append(chain[0])
            continue
        nd = face_directions(chain[m].shape[1], dev)
        acc = torch.zeros(nd.shape, device=dev)
        wacc = torch.zeros(nd.shape[:-1] + (1,), device=dev)
        for i in range(32):
            xi = _hammersley(torch.full(nd.shape[:-1], i, device=dev), 32)
            h = ggx_half_vector(xi, torch.full(nd.shape[:-1], rough, device=dev), nd)
            l = 2.0 * (nd * h).sum(-1, keepdim=True) * h - nd
            ndotl = torch.clamp((nd * l).sum(-1, keepdim=True), min=0.0)
            acc = acc + sample(chain[m], l) * ndotl
            wacc = wacc + ndotl
        specular.append(acc / torch.clamp(wacc, min=1e-6))

    # The split-sum table: rows by roughness, columns by N.V.
    t = (torch.arange(lut_size, dtype=torch.float32, device=dev) + 0.5) / lut_size
    r, nv = torch.meshgrid(t, t, indexing="ij")
    v = torch.stack([torch.sqrt(1.0 - nv * nv), torch.zeros_like(nv), nv], -1)
    nz = _vec([0.0, 0.0, 1.0], v).expand(v.shape)
    a = torch.zeros(r.shape, device=dev)
    b = torch.zeros(r.shape, device=dev)
    k = r * r / 2.0
    for i in range(lut_samples):
        xi = _hammersley(torch.full(r.shape, i, device=dev), lut_samples)
        h = ggx_half_vector(xi, r, nz)
        vh = (v * h).sum(-1, keepdim=True)
        l = 2.0 * vh * h - v
        ndotl = torch.clamp(l[..., 2], 0.0, 1.0)
        ndoth = torch.clamp(h[..., 2], 0.0, 1.0)
        vdoth = torch.clamp(vh[..., 0], 0.0, 1.0)
        g = (nv / (nv * (1 - k) + k)) * (ndotl / (ndotl * (1 - k) + k))
        g_vis = g * vdoth / torch.clamp(ndoth * nv, min=1e-6)
        fc = torch.pow(1.0 - vdoth, 5.0)
        valid = ndotl > 0.0
        a = a + torch.where(valid, (1.0 - fc) * g_vis, 0.0)
        b = b + torch.where(valid, fc * g_vis, 0.0)
    lut = torch.stack([a, b], -1) / lut_samples
    return {"chain": chain, "irradiance": irradiance, "specular": specular, "lut": lut}
