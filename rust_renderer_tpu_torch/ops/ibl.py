"""Image-based lighting: environment capture, irradiance convolution, GGX
specular prefilter and the BRDF LUT (the port of
``rust_renderer_tpu/ops/ibl.py``; utopian/src/renderers/ibl.rs and
utopian/shaders/ibl/*).

The JAX package folds each integral one sample at a time (`fori_loop`); on
the card that is one small launch per sample, so here the samples are taken
in batches of up to `_BATCH` (sample x texel) values and each batch is
summed at once. The sums are then taken in another order than the JAX
package's, which moves results by float32 rounding only (the CPU tests hold
them to 1e-4).
"""

from __future__ import annotations

import torch

from rust_renderer_tpu_torch.ops import atmosphere, brdf
from rust_renderer_tpu_torch.ops.cubemap import cube_directions, sample_cubemap
from rust_renderer_tpu_torch.ops.rays import cross, dot

PI = brdf.PI
_BATCH = 1 << 23  # (sample x texel) values per batch


def _batches(n_samples: int, per_sample: int):
    step = max(1, _BATCH // max(per_sample, 1))
    for i in range(0, n_samples, step):
        yield i, min(i + step, n_samples)


def capture_environment_cubemap(sun_dir, size: int = 512, mips: int = 8,
                                eye_height: float = 1.0) -> list[torch.Tensor]:
    """The atmosphere rendered into a cubemap mip chain (ibl.rs:68-96); each
    level is the 2x2 mean of the one above."""
    sun_dir = torch.as_tensor(sun_dir, dtype=torch.float32)
    dirs = cube_directions(size, sun_dir.device)
    origin = torch.tensor([0.0, eye_height, 0.0], device=sun_dir.device)
    color, _ = atmosphere.integrate_scattering(
        torch.broadcast_to(origin, dirs.shape), dirs, 999999999.0, sun_dir, 1.0)
    chain = [torch.clamp_max(color, 1.0)]
    for _ in range(1, mips):
        s = chain[-1].shape[1] // 2
        if s < 1:
            break
        chain.append(chain[-1].reshape(6, s, 2, s, 2, 3).mean(dim=(2, 4)))
    return chain


def irradiance_convolution(env: torch.Tensor, size: int = 64,
                           delta: float = 0.025) -> torch.Tensor:
    """Cosine-weighted hemisphere convolution (irradiance_filter.frag) of a
    (6, S, S, 3) cubemap; returns (6, size, size, 3). Sample i is at
    phi = (i // n_theta)·delta, theta = (i % n_theta)·delta."""
    n_phi = int(2.0 * PI / delta)
    n_theta = int(0.5 * PI / delta)
    dev = env.device
    normal = cube_directions(size, dev)
    right = cross(torch.tensor([0.0, 1.0, 0.0], device=dev).expand(normal.shape), normal)
    rn = torch.linalg.vector_norm(right, dim=-1, keepdim=True)
    right = torch.where(rn > 1e-4, right / torch.clamp_min(rn, 1e-9),
                        torch.tensor([1.0, 0.0, 0.0], device=dev))
    up = cross(normal, right)

    total = torch.zeros_like(normal)
    wsum = torch.zeros((), dtype=torch.float32, device=dev)
    for i0, i1 in _batches(n_phi * n_theta, normal[..., 0].numel()):
        i = torch.arange(i0, i1, device=dev)
        phi = (i // n_theta).to(torch.float32) * delta
        theta = (i % n_theta).to(torch.float32) * delta
        shape = (-1, 1, 1, 1, 1)
        tx = (torch.sin(theta) * torch.cos(phi)).reshape(shape)
        ty = (torch.sin(theta) * torch.sin(phi)).reshape(shape)
        tz = torch.cos(theta).reshape(shape)
        w = torch.cos(theta) * torch.sin(theta)
        s = sample_cubemap(env, right * tx + up * ty + normal * tz)
        total = total + (s * w.reshape(shape)).sum(0)
        wsum = wsum + w.sum()
    # The reference outputs PI * sum(L cos sin) / N; with the w-weighted
    # normalization this is sum / wsum.
    return total / torch.clamp_min(wsum, 1e-9)


def specular_prefilter(env_chain: list[torch.Tensor], mips: int = 8,
                       num_samples: int = 32) -> list[torch.Tensor]:
    """GGX-importance prefiltered specular chain (specular_filter.frag):
    level m filtered with roughness m / (mips - 1), N = V = R."""
    out = []
    for m in range(min(mips, len(env_chain))):
        size = env_chain[m].shape[1]
        roughness = m / max(mips - 1, 1)
        if roughness == 0.0:
            out.append(env_chain[0])
            continue
        dev = env_chain[m].device
        n = cube_directions(size, dev)
        total = torch.zeros_like(n)
        wsum = torch.zeros(n.shape[:-1] + (1,), dtype=torch.float32, device=dev)
        for i0, i1 in _batches(num_samples, n[..., 0].numel()):
            i = torch.arange(i0, i1, device=dev).reshape(-1, 1, 1, 1)
            xi = brdf.hammersley2d(i, num_samples)
            h = brdf.importance_sample_ggx(
                xi, torch.full(n.shape[:-1], roughness, device=dev), n)
            l = 2.0 * dot(n, h)[..., None] * h - n
            ndotl = torch.clamp_min(dot(n, l), 0.0)[..., None]
            total = total + (sample_cubemap(env_chain[m], l) * ndotl).sum(0)
            wsum = wsum + ndotl.sum(0)
        out.append(total / torch.clamp_min(wsum, 1e-6))
    return out


def brdf_lut(size: int = 512, num_samples: int = 1024, *, device) -> torch.Tensor:
    """Split-sum BRDF integration LUT (brdf_lut.frag): (size, size, 2) of
    (scale, bias), row = roughness, column = NdotV."""
    ndotv = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    rough = (torch.arange(size, dtype=torch.float32, device=device) + 0.5) / size
    r, nv = torch.meshgrid(rough, ndotv, indexing="ij")
    v = torch.stack([torch.sqrt(1.0 - nv * nv), torch.zeros_like(nv), nv], dim=-1)
    n = torch.tensor([0.0, 0.0, 1.0], device=device).expand(v.shape)
    # Karis: G_Vis = G * VdotH / (NdotH * NdotV), k = roughness^2 / 2 (IBL).
    k = r * r / 2.0
    g1v = nv / (nv * (1 - k) + k)
    a = torch.zeros_like(r)
    b = torch.zeros_like(r)
    for i0, i1 in _batches(num_samples, r.numel()):
        i = torch.arange(i0, i1, device=device).reshape(-1, 1, 1)
        h = brdf.importance_sample_ggx(brdf.hammersley2d(i, num_samples), r, n)
        vdh = dot(v, h)
        l = 2.0 * vdh[..., None] * h - v
        ndotl = torch.clamp(l[..., 2], 0.0, 1.0)
        ndoth = torch.clamp(h[..., 2], 0.0, 1.0)
        vdoth = torch.clamp(vdh, 0.0, 1.0)
        g1l = ndotl / (ndotl * (1 - k) + k)
        g_vis = g1v * g1l * vdoth / torch.clamp_min(ndoth * nv, 1e-6)
        fc = torch.pow(1.0 - vdoth, 5.0)
        valid = ndotl > 0.0
        a = a + torch.where(valid, (1.0 - fc) * g_vis, 0.0).sum(0)
        b = b + torch.where(valid, fc * g_vis, 0.0).sum(0)
    return torch.stack([a, b], dim=-1) / num_samples


def compute_environment(cfg, sun_dir, lut_samples: int = 256, *, device="cuda") -> dict:
    """The whole environment pipeline, as the persistent resources the render
    graphs read: env_cubemap_mip{m}, specular_map_mip{m}, irradiance_map,
    brdf_lut."""
    sun = torch.as_tensor(sun_dir, dtype=torch.float32).to(device)
    chain = capture_environment_cubemap(sun, cfg.cubemap_size, cfg.cubemap_mips)
    irr = irradiance_convolution(chain[min(2, len(chain) - 1)], cfg.irradiance_size)
    spec = specular_prefilter(chain, cfg.cubemap_mips)
    out = {"irradiance_map": irr,
           "brdf_lut": brdf_lut(cfg.brdf_lut_size, lut_samples, device=device)}
    for m in range(cfg.cubemap_mips):
        out[f"env_cubemap_mip{m}"] = chain[m] if m < len(chain) else chain[-1]
        out[f"specular_map_mip{m}"] = spec[m] if m < len(spec) else chain[-1]
    return out
