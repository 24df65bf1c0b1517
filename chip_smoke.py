"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernel K1 (rust_renderer_tpu_torch/csrc/traverse_wide.cu) with nvcc
into rust_renderer_tpu_torch/build/, then:

1. device: versions, the card's name and power limit, build times;
2. kernel: K1 against its plain PyTorch version on the card, on the fronts
   the main path gives it at 1920x1080 (primary rays, a random bounce front,
   a doubled [sun; light] any-hit front with per-ray t_max), with times;
3. main path: Application(1920, 1080, PATH_TRACED) on the default scene,
   5 bounces, 4 frames; K1's launch counts, per-frame times, active rays;
4. frame parity: one 128x128 scene rendered on the CPU (plain versions) and
   on the card (K1), compared under the tolerance of tests/test_torch_slice.py.

Every failed check raises. Exits non-zero, printing no result, when torch
sees no GPU. The last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

WIDTH, HEIGHT, BOUNCES, FRAMES = 1920, 1080, 5, 4
PARITY_SIZE, PARITY_FRAMES, PARITY_TIME = 128, 2, 0.25
K1_SOURCE = "rust_renderer_tpu_torch/csrc/traverse_wide.cu"
K1_REPLACES = "rust_renderer_tpu/ops/pallas/traversal.py:1568"
T_RTOL = 1e-5


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


def kernel_phase(app, traversal, rays, pathtrace) -> dict:
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


def main_path_phase(Application, StaticConfig, traversal) -> dict:
    """The PT frame at 1080p on the default scene, through the app."""
    cfg = StaticConfig(num_bounces=BOUNCES, samples_per_frame=1)
    t0 = time.perf_counter()
    app = Application(WIDTH, HEIGHT, cfg=cfg, device="cuda")
    app.create_scene()
    log(f"main path: scene + BVH build {time.perf_counter() - t0:.3f} s, "
        f"{app.scene.num_triangles} triangles, {app.scene_bvh.wnode_packed.shape[0]} "
        f"wide nodes, wide depth {app.scene_bvh.wide_depth}")
    traversal.K1_LAUNCHES.clear()
    frame_ms, img = [], None
    for i in range(FRAMES):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        res = app.render_frame()
        stop.record()
        torch.cuda.synchronize()
        frame_ms.append(start.elapsed_time(stop))
        img = res["present_output"]
        log(f"main path frame {i}: {frame_ms[-1]:.1f} ms, "
            f"pt_rays={int(app.graph.state['pt_rays'])}")
    launches = dict(traversal.K1_LAUNCHES)
    want = {"closest": (1 + BOUNCES) * FRAMES, "any_hit": BOUNCES * FRAMES}
    log(f"main path K1 launches {launches} (want {want})")
    if launches != want:
        raise AssertionError(f"K1 launches {launches}, expected {want}")
    img = img.float()
    if tuple(img.shape) != (HEIGHT, WIDTH, 3) or not bool(torch.isfinite(img).all()):
        raise AssertionError("main path output is not a finite (H, W, 3) image")
    if float(img.min()) < 0.0 or float(img.std()) <= 1e-3:
        raise AssertionError("main path output is negative or constant")
    log(f"main path output min={float(img.min()):.4f} max={float(img.max()):.4f} "
        f"mean={float(img.mean()):.4f} std={float(img.std()):.4f} "
        f"share>1={float((img > 1).float().mean()):.5f}")
    steady = sorted(frame_ms[1:])[len(frame_ms[1:]) // 2]
    log(f"main path {WIDTH}x{HEIGHT} {BOUNCES} bounces: frame ms "
        f"{[round(x, 2) for x in frame_ms]}, "
        f"median of frames 1-{FRAMES - 1} {steady:.1f} ms")
    return {"launches": sum(launches.values()), "app": app}


def parity_phase(Application, StaticConfig) -> None:
    """One small frame on the CPU (plain versions) and on the card (K1)."""
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
        log(f"parity frame {i}: rays cpu={ra:.0f} cuda={rb:.0f} within_1e-3={within:.5f} "
            f"mean_abs={mean:.3e} max_abs={float(diff.max()):.3e}")
        if ra != rb or within < 0.99 or mean > 1e-3 or not bool(torch.isfinite(b).all()):
            raise AssertionError(f"parity frame {i}: card and CPU frames disagree")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no GPU", file=sys.stderr)
        return 1
    from rust_renderer_tpu_torch import native
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.ops import pathtrace, rays, traversal
    from rust_renderer_tpu_torch.settings import StaticConfig

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = card_line()
    t0 = time.perf_counter()
    traversal.k1_library()
    log(f"K1 build {time.perf_counter() - t0:.2f} s")
    with open(native.BUILD_DIR + "/libk1_traverse_wide.so.log") as f:
        log(f.read().strip())

    main = main_path_phase(Application, StaticConfig, traversal)
    k1 = kernel_phase(main.pop("app"), traversal, rays, pathtrace)
    parity_phase(Application, StaticConfig)

    print(card)
    print(json.dumps({"kernels": [{
        "name": "k1_traverse_wide", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": main["launches"],
        "max_abs_err": k1["max_abs_err"], "ms": k1["ms"], "plain_ms": k1["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
