"""ReSTIR / RIS light sampling over analytic point lights, the port of
``rust_renderer_tpu/ops/restir.py`` (utopian/shaders/include/
restir_sampling.glsl and the restir/*.rgen passes):

- target function p_hat = luminance(intensity / d^2) (restir_sampling.glsl:59-69)
- uniform light proposal over min(num_lights, max_num_lights_used) (:71-77)
- weighted reservoir update (:85-93) and 32-candidate RIS (:96-130)
- W_X = (1/p_hat) * W_sum / M (:79-82)
- temporal reuse with backprojection + 20x M-clamp (temporal_reuse.rgen:86-115)
- spatial reuse over 5 random neighbours in a 30 px radius (spatial_reuse.rgen:50-66)

Reservoirs are (H, W) planes. Each pass also hands on p_hat of its selected
sample, tracked by Y-equality (exact: p_hat depends only on Y and the hit
position), so no pass re-evaluates it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from rust_renderer_tpu_torch.ops import rng as rngmod
from rust_renderer_tpu_torch.ops.gather import row_gather


class Reservoir(NamedTuple):
    Y: torch.Tensor  # (...,) i32 selected light index (-1 = none)
    W_sum: torch.Tensor  # (...,) f32
    W_X: torch.Tensor  # (...,) f32 unbiased contribution weight
    M: torch.Tensor  # (...,) i32 sample count

    @staticmethod
    def empty(shape, device) -> "Reservoir":
        return Reservoir(
            Y=torch.full(shape, -1, dtype=torch.int32, device=device),
            W_sum=torch.zeros(shape, dtype=torch.float32, device=device),
            W_X=torch.zeros(shape, dtype=torch.float32, device=device),
            M=torch.zeros(shape, dtype=torch.int32, device=device),
        )

    def where(self, cond: torch.Tensor, other: "Reservoir") -> "Reservoir":
        """Per pixel: this reservoir where `cond`, else `other`."""
        return Reservoir(*(torch.where(cond, a, b) for a, b in zip(self, other)))


def _pack_reservoir_rows(r: Reservoir) -> torch.Tensor:
    """(H, W) planes -> (H*W, 4) rows [Y, W_sum, W_X, M] (ints bitcast)."""
    cols = torch.stack([r.Y.view(torch.float32), r.W_sum, r.W_X,
                        r.M.view(torch.float32)], dim=-1)
    return cols.reshape(-1, 4)


def _gather_reservoir_rows(packed, iy, ix, width: int) -> Reservoir:
    """Fetch reservoirs at integer pixel coords (same shape as iy/ix)."""
    shape = iy.shape
    rows = row_gather(packed, (iy * width + ix).reshape(-1))
    return Reservoir(
        Y=rows[:, 0].contiguous().view(torch.int32).reshape(shape),
        W_sum=rows[:, 1].reshape(shape),
        W_X=rows[:, 2].reshape(shape),
        M=rows[:, 3].contiguous().view(torch.int32).reshape(shape),
    )


def _light_rows(scene) -> torch.Tensor:
    """Packed light rows (L, 6): pos.xyz, intensity.xyz."""
    return torch.cat([scene.light_pos, scene.light_intensity], dim=1)


def select_light_rows(scene, idx: torch.Tensor) -> torch.Tensor:
    """Per-pixel light rows (R, 6) for clamped light indices (R,). A row
    gather: the same values as the JAX package's one-hot product."""
    return row_gather(_light_rows(scene), idx)


def target_function(scene, light_index: torch.Tensor,
                    hit_position: torch.Tensor) -> torch.Tensor:
    """p_hat = luminance(intensity / d^2) (restir_sampling.glsl:64-69); 0 for
    light_index == -1."""
    shape = light_index.shape
    idx = light_index.clamp(0, scene.light_pos.shape[0] - 1).reshape(-1)
    rows = select_light_rows(scene, idx)
    hp = hit_position.reshape(-1, 3)
    dx = rows[:, 0] - hp[:, 0]
    dy = rows[:, 1] - hp[:, 1]
    dz = rows[:, 2] - hp[:, 2]
    d2 = dx * dx + dy * dy + dz * dz
    lum = 0.2126 * rows[:, 3] + 0.7152 * rows[:, 4] + 0.0722 * rows[:, 5]
    p_hat = (lum / torch.clamp_min(d2, 1e-12)).reshape(shape)
    return torch.where(light_index < 0, 0.0, p_hat)


def sample_light_uniform(state, num_lights, max_num_lights_used):
    """Uniform proposal (restir_sampling.glsl:71-77).
    Returns (state, light_index i32, pdf f32)."""
    num_used = torch.minimum(num_lights, max_num_lights_used).to(torch.float32)
    state, r = rngmod.random_float(state)
    idx = (r * num_used).to(torch.int32)
    idx = torch.minimum(idx, num_used.to(torch.int32) - 1)  # guard r == 1.0
    return state, idx, 1.0 / torch.clamp_min(num_used, 1.0)


def update_reservoir(state, res: Reservoir, Xi, w_i, M):
    """Weighted reservoir update (restir_sampling.glsl:85-93)."""
    W_sum = res.W_sum + w_i
    M_new = res.M + M
    state, r = rngmod.random_float(state)
    take = r * W_sum < w_i
    return state, Reservoir(Y=torch.where(take, Xi, res.Y), W_sum=W_sum,
                            W_X=res.W_X, M=M_new)


def finalize_resampling(res: Reservoir, p_hat: torch.Tensor) -> Reservoir:
    """W_X = (1/p_hat) * W_sum / M (restir_sampling.glsl:79-82)."""
    W_X = torch.where(
        p_hat == 0.0, 0.0,
        (1.0 / torch.clamp_min(p_hat, 1e-20)) * res.W_sum / torch.clamp_min(res.M, 1))
    return res._replace(W_X=W_X)


def _resample_phat(scene, state, hit_position, num_lights, max_num_lights_used,
                   num_candidates: int = 32):
    """Fresh RIS over `num_candidates` uniform proposals
    (restir_sampling.glsl:96-130). Returns (state, reservoir, p_hat of the
    selected sample)."""
    shape = state.shape
    res = Reservoir.empty(shape, state.device)
    p_sel = torch.zeros(shape, dtype=torch.float32, device=state.device)
    m_i = 1.0 / num_candidates
    one = torch.ones(shape, dtype=torch.int32, device=state.device)
    for _ in range(num_candidates):
        state, cand, p = sample_light_uniform(state, num_lights, max_num_lights_used)
        p_hat = target_function(scene, cand, hit_position)
        w_i = m_i * p_hat * (1.0 / p)
        state, res = update_reservoir(state, res, cand, w_i, one)
        p_sel = torch.where(res.Y == cand, p_hat, p_sel)
    # M forced to 1 (restir_sampling.glsl:119-121).
    res = res._replace(M=one)
    p_sel = torch.where(res.Y < 0, 0.0, p_sel)
    res = finalize_resampling(res, p_sel)
    res = res._replace(W_X=torch.where(res.Y < 0, 0.0, res.W_X))
    return state, res, p_sel


def initial_ris_pass(scene, state, hit_position, num_lights, max_num_lights_used,
                     num_candidates: int = 32):
    """restir/initial_ris.rgen: fresh RIS fed through one more reservoir with
    weight W_sum * M, then finalized. Returns (state, reservoir, p_hat)."""
    state, r, p_sel = _resample_phat(scene, state, hit_position, num_lights,
                                     max_num_lights_used, num_candidates)
    new = Reservoir.empty(state.shape, state.device)
    state, new = update_reservoir(state, new, r.Y, r.W_sum * r.M.to(torch.float32), r.M)
    p_hat = torch.where(new.Y == r.Y, p_sel, 0.0)  # new.Y is r.Y or -1
    new = finalize_resampling(new, p_hat)
    return state, new, torch.where(new.Y < 0, 0.0, p_hat)


def temporal_reuse_pass(scene, state, hit_position, initial: Reservoir,
                        prev_frame: Reservoir, prev_frame_projection_view,
                        enabled, p_hat_initial):
    """restir/temporal_reuse.rgen:35-121: combine with the previous frame's
    reservoir at the backprojected pixel. hit_position (H,W,3); reservoir
    planes (H,W); p_hat_initial is p_hat of `initial`'s sample. Returns
    (state, reservoir, its p_hat)."""
    h, w = initial.Y.shape

    new = Reservoir.empty((h, w), state.device)
    p_hat = p_hat_initial
    initial_weight = p_hat * initial.W_X * initial.M.to(torch.float32)
    state, new = update_reservoir(state, new, initial.Y, initial_weight, initial.M)

    # Backproject to the previous frame (temporal_reuse.rgen:88-103).
    m = prev_frame_projection_view
    hx, hy, hz = hit_position[..., 0], hit_position[..., 1], hit_position[..., 2]

    def row(j):
        return hx * m[j, 0] + hy * m[j, 1] + hz * m[j, 2] + m[j, 3]

    clip_w = row(3)
    u = (row(0) / clip_w) * 0.5 + 0.5
    v = 1.0 - ((row(1) / clip_w) * 0.5 + 0.5)
    in_bounds = (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
    px = (u * w + 0.5).to(torch.int32).clamp(0, w - 1)
    py = (v * h + 0.5).to(torch.int32).clamp(0, h - 1)
    fetched = _gather_reservoir_rows(_pack_reservoir_rows(prev_frame), py, px, w)
    prev = fetched.where(in_bounds, Reservoir.empty((h, w), state.device))

    # p_hat reweighting for target-distribution mismatch + 20x M clamp
    # (temporal_reuse.rgen:100-115).
    p_hat_prev = target_function(scene, prev.Y, hit_position)
    M_clamped = torch.minimum(20 * initial.M, prev.M)
    prev_weight = p_hat_prev * prev.W_X * M_clamped.to(torch.float32)
    state, new = update_reservoir(state, new, prev.Y, prev_weight, M_clamped)

    p_hat_new = torch.where(new.Y < 0, 0.0,
                            torch.where(new.Y == initial.Y, p_hat, p_hat_prev))
    new = finalize_resampling(new, p_hat_new)
    new = new._replace(W_X=torch.where(new.Y < 0, 0.0, new.W_X))

    # Disabled = passthrough (temporal_reuse.rgen:43-46).
    on = enabled == 1
    return state, new.where(on, initial), torch.where(on, p_hat_new, p_hat)


def spatial_reuse_pass(scene, state, hit_position, temporal: Reservoir, enabled,
                       num_neighbors: int = 5, radius: int = 30,
                       p_hat_temporal=None) -> tuple[torch.Tensor, Reservoir]:
    """restir/spatial_reuse.rgen:35-75: combine with `num_neighbors` random
    neighbours within `radius` pixels. p_hat_temporal is p_hat of
    `temporal`'s sample."""
    h, w = temporal.Y.shape
    dev = state.device
    new = Reservoir.empty((h, w), dev)
    p_hat = p_hat_temporal
    state, new = update_reservoir(
        state, new, temporal.Y,
        p_hat * temporal.W_X * temporal.M.to(torch.float32), temporal.M)
    p_sel = torch.where(new.Y == temporal.Y, p_hat, 0.0)

    yy = torch.arange(h, dtype=torch.int32, device=dev)[:, None].expand(h, w)
    xx = torch.arange(w, dtype=torch.int32, device=dev)[None, :].expand(h, w)
    src_packed = _pack_reservoir_rows(temporal)

    for _ in range(num_neighbors):
        state, off = rngmod.random_vec2(state)
        off = (off * 2.0 - 1.0) * radius
        nx = (xx + off[..., 0].to(torch.int32)).clamp(0, w - 1)
        ny = (yy + off[..., 1].to(torch.int32)).clamp(0, h - 1)
        nb = _gather_reservoir_rows(src_packed, ny, nx, w)
        p_hat_nb = target_function(scene, nb.Y, hit_position)
        state, new = update_reservoir(
            state, new, nb.Y, p_hat_nb * nb.W_X * nb.M.to(torch.float32), nb.M)
        p_sel = torch.where(new.Y == nb.Y, p_hat_nb, p_sel)

    p_hat_new = torch.where(new.Y < 0, 0.0, p_sel)
    new = finalize_resampling(new, p_hat_new)
    new = new._replace(W_X=torch.where(new.Y < 0, 0.0, new.W_X))

    on = enabled == 1
    return state, new.where(on, temporal)
