"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernels K1 (rust_renderer_tpu_torch/csrc/traverse_wide.cu) and K4 / K5
(csrc/raster_binned.cu) with nvcc into rust_renderer_tpu_torch/build/, one
nvcc per source, started together; then:

1. device: versions, the card's name and power limit, build times;
2. PT main path: Application(1920, 1080, PATH_TRACED) on the default scene,
   5 bounces, 4 frames; launch counts, per-frame times, active rays;
3. K1 against its plain PyTorch version on the card, on the fronts the PT
   path gives it at 1920x1080, with times;
4. PT parity: one 128x128 scene on the CPU (plain versions) and on the card;
5. RASTERIZED main path: Application(1920, 1080, RASTERIZED), default
   StaticConfig (4 shadow cascades of 4096^2, 512^2 cubemap), marching
   cubes on, 4 frames; launch counts, frame times (frame 1, which captures
   the environment, apart), per-pass times of one more frame;
6. MINIMAL main path: the same at 1920x1080;
7. K4 against its plain version on the 4 cascades of the default scene at
   4096^2, and K5 on the marching-cubes front at 1920x1080 over the gbuffer
   depth, with times, global-list lengths and longest segments;
8. raster parity: one small RASTERIZED frame with marching cubes on the CPU
   (brute rasterizer, plain walk) and on the card (K4, K5, K1).

Each main path is driven with every launch count set to 0 just before it
and read just after. Every failed check raises. Exits non-zero, printing no
result, when torch sees no GPU. The last line is {"ok": true, ...}.
"""

from __future__ import annotations

import concurrent.futures
import json
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT, BOUNCES, FRAMES = 1920, 1080, 5, 4
PARITY_SIZE, PARITY_FRAMES, PARITY_TIME = 128, 2, 0.25
RASTER_PARITY_SIZE = 96
SOURCES = {
    "k1": ("rust_renderer_tpu_torch/csrc/traverse_wide.cu",
           "rust_renderer_tpu/ops/pallas/traversal.py:1568"),
    "k4": ("rust_renderer_tpu_torch/csrc/raster_binned.cu",
           "rust_renderer_tpu/ops/raster_binned.py:258"),
    "k5": ("rust_renderer_tpu_torch/csrc/raster_binned.cu",
           "rust_renderer_tpu/ops/raster_binned.py:304"),
}
T_RTOL = 1e-5
VIS_ATOL = 1e-5


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over `reps` calls, by CUDA events."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


class Launches:
    """The kernels' launch counters: zeroed before a main path, read after."""

    def __init__(self, traversal, raster_binned):
        self.traversal, self.raster_binned = traversal, raster_binned

    def reset(self) -> None:
        self.traversal.K1_LAUNCHES.clear()
        self.raster_binned.K4_LAUNCHES = 0
        self.raster_binned.K5_LAUNCHES = 0

    def read(self) -> dict:
        k1 = self.traversal.K1_LAUNCHES
        return {"k1_closest": k1["closest"], "k1_any_hit": k1["any_hit"],
                "k4": self.raster_binned.K4_LAUNCHES, "k5": self.raster_binned.K5_LAUNCHES}


def check_image(label: str, img: torch.Tensor) -> None:
    img = img.float()
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError(f"{label}: output is not a finite (H, W, 3) image")
    if float(img.min()) < 0.0 or float(img.std()) <= 1e-3:
        raise AssertionError(f"{label}: output is negative or constant")
    log(f"{label} output min={float(img.min()):.4f} max={float(img.max()):.4f} "
        f"mean={float(img.mean()):.4f} std={float(img.std()):.4f}")


def run_frames(label: str, app, launches: Launches, want: dict) -> dict:
    """FRAMES frames through app.render_frame with the counts zeroed first;
    raises unless the counts are `want` per frame."""
    launches.reset()
    frame_ms, img = [], None
    for i in range(FRAMES):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = app.render_frame()
        stop.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(stop))
        img = res["present_output"]
        if "pt_rays" in res:
            log(f"{label} frame {i}: {frame_ms[-1]:.1f} ms, pt_rays={int(res['pt_rays'])}")
    got = launches.read()
    want = {k: v * FRAMES for k, v in want.items()}
    log(f"{label} launches {got} (want {want})")
    if got != want:
        raise AssertionError(f"{label}: launches {got}, expected {want}")
    check_image(label, img)
    steady = sorted(frame_ms[1:])[len(frame_ms[1:]) // 2]
    log(f"{label} {WIDTH}x{HEIGHT}: frame ms {[round(x, 2) for x in frame_ms]}, "
        f"frame 1 {frame_ms[0]:.1f} ms, median of frames 2-{FRAMES} {steady:.1f} ms")
    return got


def pass_times(label: str, app) -> dict:
    """One more frame with CUDA events around every pass body; returns each
    pass's outputs."""
    app._refresh_view()
    app._ensure_environment()
    app._build_graph()
    events, outputs = [], {}
    for p in app.graph.passes:
        def timed(res, scene, view, fn=p.fn, name=p.name):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            outputs[name] = fn(res, scene, view)
            stop.record()
            events.append((name, start, stop))
            return outputs[name]
        p.fn = timed
    app.graph.render(app.scene, app.view)
    torch.cuda.synchronize()
    log(f"{label} per-pass ms: " + ", ".join(
        f"{name} {a.elapsed_time(b):.2f}" for name, a, b in events))
    return outputs


# -- PT (unchanged phases) -----------------------------------------------------


def compare_hits(label, k1, plain, any_hit) -> float:
    """Raise unless K1 and the plain walk agree; returns max |t| error."""
    tk, pk = k1[0], k1[1]
    tp, pp = plain[0], plain[1]
    hk, hp = pk >= 0, pp >= 0
    if not torch.equal(hk, hp):
        raise AssertionError(f"{label}: hit flags differ on {int((hk != hp).sum())} rays")
    if any_hit:
        return 0.0
    both = hk & hp
    err = (tk - tp).abs()[both]
    rel = err / tp.abs()[both]
    if rel.numel() and float(rel.max()) > T_RTOL:
        raise AssertionError(f"{label}: t differs by {float(rel.max())} relative")
    tie = (tk - tp).abs() <= T_RTOL * tp.abs()
    if not bool(((pk == pp) | tie | ~both).all()):
        raise AssertionError(f"{label}: prim differs off ties")
    return float(err.max()) if err.numel() else 0.0


def k1_phase(app, traversal, rays, pathtrace) -> dict:
    """K1 against the plain walk on 1080p fronts of the default scene."""
    dev = app.device
    bvh = app.scene_bvh
    view = app.view.with_camera(app.camera, WIDTH, HEIGHT).to(dev)
    py, px = pathtrace.pixel_grid(HEIGHT, WIDTH, dev)
    o, d = rays.generate_camera_rays(view.inverse_view, view.inverse_projection,
                                     px.float() + 0.5, py.float() + 0.5, WIDTH, HEIGHT)
    n = WIDTH * HEIGHT
    o, d = o.reshape(n, 3).contiguous(), d.reshape(n, 3).contiguous()
    t_min = torch.full((n,), 1e-3, device=dev)
    t_max = torch.full((n,), 1e4, device=dev)
    t_hit, prim = traversal.traverse_wide_cuda(bvh.wnode_packed, bvh.leaf_packed,
                                               bvh.wide_depth, o, d, t_min, t_max,
                                               False)[:2]
    hit = prim >= 0
    pos = o + t_hit[:, None] * d
    gen = torch.Generator(device=dev).manual_seed(7)
    bounce_d = torch.randn((n, 3), device=dev, generator=gen)
    bounce_d = torch.where(hit[:, None], bounce_d / bounce_d.norm(dim=1, keepdim=True), 0.0)
    bounce_o = torch.where(hit[:, None], pos - 1e-3 * d, o)
    sun = torch.tensor([0.0, 0.90631, 0.42262], device=dev)
    sun = sun / sun.norm()
    lights = app.scene.light_pos
    pick = torch.randint(0, lights.shape[0], (n,), device=dev, generator=gen)
    to_light = lights[pick] - bounce_o
    dist = to_light.norm(dim=1)
    fronts = {
        "primary": (o, d, t_min, t_max, False),
        "bounce": (bounce_o.contiguous(), bounce_d.contiguous(), t_min, t_max, False),
        "nee_any_hit": (
            torch.cat([bounce_o, bounce_o]).contiguous(),
            torch.cat([torch.where(hit[:, None], sun.expand(n, 3), 0.0),
                       torch.where(hit[:, None], to_light / dist[:, None], 0.0)]).contiguous(),
            torch.cat([t_min, t_min]),
            torch.cat([t_max, dist * (1.0 - 1e-4)]).contiguous(),
            True),
    }
    result = {"max_abs_err": 0.0}
    for name, (fo, fd, fmin, fmax, any_hit) in fronts.items():
        k1 = lambda: traversal.traverse_wide_cuda(bvh.wnode_packed, bvh.leaf_packed,
                                                  bvh.wide_depth, fo, fd, fmin, fmax,
                                                  any_hit)
        plain = lambda: traversal.traverse_plain(bvh.node_packed, bvh.leaf_packed,
                                                 fo, fd, fmin, fmax, any_hit)
        got, want = k1(), plain()
        torch.cuda.synchronize()
        err = compare_hits(name, got, want, any_hit)
        k1(), plain()  # warm-up
        k1_ms = cuda_ms(k1, 20)
        plain_ms = cuda_ms(plain, 2)
        live = int((fd * fd).sum(dim=1).gt(0).sum())
        log(f"kernel K1 front={name} rays={fd.shape[0]} live={live} "
            f"hits={int((got[1] >= 0).sum())} max_abs_err_t={err:.3e} "
            f"k1_ms={k1_ms:.4f} plain_ms={plain_ms:.3f}")
        result["max_abs_err"] = max(result["max_abs_err"], err)
        if name == "primary":
            result["ms"], result["plain_ms"] = k1_ms, plain_ms
    return result


def pt_parity_phase(Application, StaticConfig) -> None:
    """One small PT frame on the CPU (plain versions) and on the card (K1)."""
    frames = {}
    for device in ("cpu", "cuda"):
        app = Application(PARITY_SIZE, PARITY_SIZE,
                          cfg=StaticConfig(num_bounces=BOUNCES), device=device)
        app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
        app.create_scene()
        out = []
        for _ in range(PARITY_FRAMES):
            res = app.render_frame()
            out.append((res["present_output"].cpu(),
                        float(app.graph.state["pt_rays"].cpu())))
        frames[device] = out
    for i, ((a, ra), (b, rb)) in enumerate(zip(frames["cpu"], frames["cuda"])):
        diff = (a - b).abs()
        within = float((diff.amax(dim=-1) <= 1e-3).float().mean())
        mean = float(diff.mean())
        log(f"pt parity frame {i}: rays cpu={ra:.0f} cuda={rb:.0f} within_1e-3={within:.5f} "
            f"mean_abs={mean:.3e} max_abs={float(diff.max()):.3e}")
        if ra != rb or within < 0.99 or mean > 1e-3 or not bool(torch.isfinite(b).all()):
            raise AssertionError(f"pt parity frame {i}: card and CPU frames disagree")


# -- rasterizer ----------------------------------------------------------------


def k4_phase(app, raster, raster_binned, shadow) -> dict:
    """K4 against its plain version on the default scene's cascades."""
    cfg, scene = app.cfg, app.scene
    size = cfg.shadow_map_size
    matrices, _ = shadow.cascade_matrices(
        app.camera.get_view(), app.camera.get_projection(), app.camera.get_near_plane(),
        app.camera.get_far_plane(), app.sun_dir, cfg.shadow_cascade_count)
    k4_ms, plain_ms, err = [], [], 0.0
    for i, m in enumerate(torch.as_tensor(matrices, device=app.device)):
        clip = raster.transform_vertices(scene.positions, m)
        bins = raster_binned.bin_triangles(
            raster_binned.tri_rows(clip, scene.indices, size, size), size, size)
        k4 = lambda: raster_binned.depth_binned_cuda(bins, size, size)
        plain = lambda: raster_binned.depth_binned_plain(bins, size, size)
        got, want = k4(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 cascade {i}: depth differs from the plain version on "
                                 f"{int((got != want).sum())} texels")
        err = max(err, float((got - want).abs().max()))
        k4_ms.append(cuda_ms(k4, 5))
        plain_ms.append(cuda_ms(plain, 1))
        log(f"kernel K4 cascade={i} {size}x{size} rows={bins.table.shape[0]} "
            f"global={bins.g_count} longest_segment={int(bins.counts.max())} "
            f"covered={float((got < 1).float().mean()):.4f} bit_equal=True "
            f"k4_ms={k4_ms[-1]:.4f} plain_ms={plain_ms[-1]:.3f}")
    return {"max_abs_err": err, "ms": sum(k4_ms) / len(k4_ms),
            "plain_ms": sum(plain_ms) / len(plain_ms)}


def k5_phase(app, raster, raster_binned, marching_cubes, gbuffer_depth) -> dict:
    """K5 against its plain version on the marching-cubes front at 1080p,
    and the LOAD-op merge over the gbuffer depth."""
    dev = app.device
    view = app.view.to(dev)
    result = marching_cubes.marching_cubes(grid=app.cfg.mc_grid,
                                           voxel_size=32.0 / app.cfg.mc_grid, time=view.time)
    t = result.positions.shape[0]
    clip = raster.transform_vertices(result.positions.reshape(-1, 3),
                                     view.projection @ view.view)
    idx = torch.arange(3 * t, dtype=torch.int32, device=dev).reshape(-1, 3)
    bins = raster_binned.bin_triangles(
        raster_binned.tri_rows(clip, idx, WIDTH, HEIGHT, vis=True), WIDTH, HEIGHT)
    k5 = lambda: raster_binned.vis_binned_cuda(bins, WIDTH, HEIGHT)
    plain = lambda: raster_binned.vis_binned_plain(bins, WIDTH, HEIGHT)
    got, want = k5(), plain()
    torch.cuda.synchronize()
    init = raster.VisibilityBuffer(
        depth=gbuffer_depth, tri=torch.full_like(want.tri, -1),
        bary_u=torch.zeros_like(gbuffer_depth), bary_v=torch.zeros_like(gbuffer_depth))
    merged = [raster.merge_visibility(v, init) for v in (got, want)]
    err = 0.0
    for label, (a, b) in (("raw", (got, want)), ("over gbuffer depth", merged)):
        if not torch.equal(a.tri, b.tri):
            raise AssertionError(f"K5 {label}: triangle ids differ on "
                                 f"{int((a.tri != b.tri).sum())} pixels")
        for name in ("depth", "bary_u", "bary_v"):
            e = float((getattr(a, name) - getattr(b, name)).abs().max())
            if e > VIS_ATOL:
                raise AssertionError(f"K5 {label}: {name} differs by {e}")
            err = max(err, e)
    k5_ms = cuda_ms(k5, 10)
    plain_ms = cuda_ms(plain, 2)
    log(f"kernel K5 marching-cubes front {WIDTH}x{HEIGHT} slots={t} rows={bins.table.shape[0]} "
        f"valid={int(result.valid.sum())} global={bins.g_count} "
        f"longest_segment={int(bins.counts.max())} "
        f"covered={float((got.tri >= 0).float().mean()):.4f} "
        f"drawn_over_gbuffer={float((merged[0].tri >= 0).float().mean()):.4f} "
        f"max_abs_err={err:.3e} k5_ms={k5_ms:.4f} plain_ms={plain_ms:.3f}")
    return {"max_abs_err": err, "ms": k5_ms, "plain_ms": plain_ms}


def raster_parity_phase(Application, StaticConfig, RenderGraphMode) -> None:
    """One small RASTERIZED frame with marching cubes on the card (K4, K5,
    K1) and twice on the CPU: with the kernels' plain versions
    (raster_method="binned"), under the tolerance of
    tests/test_torch_raster_slice.py, and with the brute rasterizer, whose
    depth arithmetic rounds differently: a shadow tap within ~1e-5 of the
    0.0005 bias can flip, so that comparison is held to 97% of pixels."""
    size = RASTER_PARITY_SIZE
    cfg = StaticConfig(shadow_map_size=128, cubemap_size=32, cubemap_mips=4,
                       irradiance_size=8, brdf_lut_size=32, mc_grid=16)
    frames = {}
    for label, device, method in (("cuda", "cuda", "auto"), ("cpu binned", "cpu", "binned"),
                                  ("cpu brute", "cpu", "auto")):
        app = Application(size, size, RenderGraphMode.RASTERIZED,
                          cfg=cfg.replace(raster_method=method), device=device)
        app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
        app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
        app.create_scene()
        res = app.render_frame()
        frames[label] = (res["present_output"].cpu(),
                         int(res["marching_cubes_draw_count"][0].cpu()))
    b, cb = frames["cuda"]
    if not bool(torch.isfinite(b).all()):
        raise AssertionError("raster parity: the card's frame is not finite")
    for label, share in (("cpu binned", 0.99), ("cpu brute", 0.97)):
        a, ca = frames[label]
        diff = (a - b).abs()
        within = float((diff.amax(dim=-1) <= 1e-3).float().mean())
        mean = float(diff.mean())
        log(f"raster parity {size}x{size} card vs {label}: mc vertices {ca} / {cb} "
            f"within_1e-3={within:.5f} mean_abs={mean:.3e} max_abs={float(diff.max()):.3e}")
        if ca != cb or within < share or mean > 1e-3:
            raise AssertionError(f"raster parity: card and {label} frames disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no GPU", file=sys.stderr)
        return 1
    from rust_renderer_tpu_torch import native
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.ops import (
        marching_cubes, pathtrace, raster, raster_binned, rays, shadow, traversal)
    from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = card_line()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for f in [pool.submit(traversal.k1_library), pool.submit(raster_binned.library)]:
            f.result()
    log(f"K1 + K4/K5 build (in parallel) {time.perf_counter() - t0:.2f} s")
    for lib in ("k1_traverse_wide", "k45_raster_binned"):
        with open(f"{native.BUILD_DIR}/lib{lib}.so.log") as f:
            log(f.read().strip())
    launches = Launches(traversal, raster_binned)
    counted = {}

    def add(got):
        for k, v in got.items():
            counted[k] = counted.get(k, 0) + v

    # PATH_TRACED.
    t0 = time.perf_counter()
    app = Application(WIDTH, HEIGHT, cfg=StaticConfig(num_bounces=BOUNCES), device="cuda")
    app.create_scene()
    log(f"PT: scene + BVH build {time.perf_counter() - t0:.3f} s, "
        f"{app.scene.num_triangles} triangles, {app.scene_bvh.wnode_packed.shape[0]} "
        f"wide nodes, wide depth {app.scene_bvh.wide_depth}")
    add(run_frames("PT", app, launches, {"k1_closest": 1 + BOUNCES, "k1_any_hit": BOUNCES,
                                         "k4": 0, "k5": 0}))
    k1 = k1_phase(app, traversal, rays, pathtrace)
    del app
    pt_parity_phase(Application, StaticConfig)

    # RASTERIZED with the marching-cubes draw.
    app = Application(WIDTH, HEIGHT, RenderGraphMode.RASTERIZED, device="cuda")
    app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
    app.create_scene()
    add(run_frames("RASTERIZED", app, launches,
                   {"k1_closest": 2, "k1_any_hit": 1, "k4": 4, "k5": 1}))
    gbuffer_depth = pass_times("RASTERIZED", app)["gbuffer"]["gbuffer_depth"]
    k4 = k4_phase(app, raster, raster_binned, shadow)
    k5 = k5_phase(app, raster, raster_binned, marching_cubes, gbuffer_depth)
    log(f"RASTERIZED peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del app, gbuffer_depth

    # MINIMAL.
    app = Application(WIDTH, HEIGHT, RenderGraphMode.MINIMAL, device="cuda")
    app.create_scene()
    add(run_frames("MINIMAL", app, launches,
                   {"k1_closest": 1, "k1_any_hit": 0, "k4": 4, "k5": 0}))
    pass_times("MINIMAL", app)
    del app
    raster_parity_phase(Application, StaticConfig, RenderGraphMode)

    kernels = []
    for name, key, launched, stats in (
            ("k1_traverse_wide", "k1", counted["k1_closest"] + counted["k1_any_hit"], k1),
            ("k4_depth_binned", "k4", counted["k4"], k4),
            ("k5_vis_binned", "k5", counted["k5"], k5)):
        source, replaces = SOURCES[key]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launched,
                        "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
                        "plain_ms": stats["plain_ms"]})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
