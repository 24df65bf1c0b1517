"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --k5    # K5's times alone (`k5_alone`)
    python3 chip_smoke.py --app   # the app phase alone (`app_alone`)
    python3 chip_smoke.py --tiles # the tiles phase alone (`tiles_alone`)
    python3 chip_smoke.py --raster # the raster apps' host frames and passes alone
    python3 chip_smoke.py --sky   # the sky kernel alone (`sky_alone`)
    python3 chip_smoke.py --k4    # K4 alone on the Sponza-scale cascades (`k4_alone`)
    python3 chip_smoke.py --deferred # the deferred kernel alone (`deferred_alone`)
    python3 chip_smoke.py --ssao  # the SSAO kernels alone (`ssao_alone`)

Builds every library the port's modules declare (`native.LIBRARIES`: the
traversal kernels of ops/traversal.py, the seed kernel of ops/bvh.py, the
sky kernel of ops/atmosphere.py, the deferred kernel of ops/deferred.py,
the SSAO kernels of ops/ssao.py, K4 / K5 of ops/raster_binned.py, all from
rust_renderer_tpu_torch/csrc/ with nvcc, and the BVH builder with g++) into
rust_renderer_tpu_torch/build/, one compiler per library, started together;
then:

1. device: versions, the card's name and power limit, build times;
2. PT main path: Application(1920, 1080, PATH_TRACED) on the default scene,
   5 bounces, 4 frames at the StaticConfig defaults (compaction windows of
   64 / 128 ray blocks, Morton order, seed test of 4 rows), then frames in
   turns with those four fields 0, at the defaults, and with seed_rows 0
   alone; launch counts, per-frame times, active rays, the ratios of the
   frame times;
3. K1 against its plain PyTorch version on the card, on the fronts the PT
   path gives it at 1920x1080, with times;
4. PT device loop (`Application.run_on_device`, `Graph.render_loop`): two
   apps of the default scene from one starting state, 4 host frames
   against run_on_device(4) (frame 1 eagerly, the capture into a CUDA
   graph, 3 replays), then 4 more of each (pure replay): the form
   "captured" with one capture, accumulation, reservoirs, pt_rays and the
   image bit-equal (or within 1e-6, printed), the launch counters (the
   first call moves two frames' worth: frame 1 and the capture's
   recording; a replay none), ms per frame of each loop and the device's
   busy share of one torch.profiler window of each;
5. PT parity: one 128x128 scene at the defaults on the CPU (plain versions)
   and on the card;
6. config 5 (bench.py:251-253): Application(1920, 1080, PATH_TRACED) on the
   default scene at the bench's PT settings with
   view.marching_cubes_enabled = 1 (mc_grid 32): 4 frames (launches a
   frame: K1 12 closest + 10 any-hit, the seed kernel 5, nothing else),
   per-pass ms (mc_extract and mc_refit apart), the MC material's pixels in
   the bench's view, the refit tables' size, the frame with MC off and on
   in turns; K1 on the dynamic tree against the plain walk on config 5's
   primary, bounce and NEE fronts, timed beside K1 on the scene's tree,
   with its own walk's bound; then its device loop as phase 4 (with the
   peak device memory of the first call, the stacked prefix tables
   included);
7. MC PT parity: one 128x128 config-5 frame with the camera on the MC
   region, on the CPU and on the card;
8. Sponza-scale PT main path: the 260k-triangle scene with the bench's
   settings (cubemap sky, 5 bounces, 1 spp), 4 frames at 1920x1080 at the
   defaults, then the turns of phase 2; scene and BVH build times (the
   q32 collapse included), launch counts; then its device loop as phase 4;
9. traversal variants: on the primary, bounce and any-hit fronts of both
   scenes at 1920x1080, `traverse(...)` under every kernel option set (K3-lq
   at flush_k 4 and 8, K3-multi at m 2, 4 and 8 among them): each launch
   moves the counter of the kernel that `select_kernel` names, each result
   is held against the plain walk (K3-multi also against K3 wide, bit for
   bit), each option set is timed beside K1 on the same front; a table of
   K1 beside K3 wide and K3 wide ordered on the six fronts;
10. K1's bounds: K1's stats form (`traverse(..., phase_stats=True)`) counts
   the child-box slab tests and triangle tests of K1's own walk on each
   front, K3's stats those of K3 wide's walk (the yardstick of the other
   kernels); a bound is the larger of operations over 33.5e12 unfused f32
   operations/s and bytes over 3.35 TB/s. K2's leaf-queue depth per ray on
   each front, with the queue uncapped and at K2_QUEUE_CAP, and its scratch
   bytes per launch;
11. compaction: on the same fronts, `traverse_compacted` around K1 at the
   frame's two window requests (45 / 81 blocks on a 1080p front, 54 / 90 on
   the doubled any-hit front), "live" and "morton" orders, and around
   K3-multi (m = 4) on the any-hit fronts: hits bit-equal to K1's; device
   times of the permutation alone and of the walk of the permuted front,
   event times of the permutation and of the whole call, beside K1 alone;
   the live-lane share;
12. seed test: on the any-hit front of each scene, the seed kernel against
   its plain version (verdicts and walk directions), seeded any-hit against
   the walk, the share of rays it kills, its device time against its
   bound, seed + K1 against K1 alone by events; then the sky kernel
   (`sky_phase`) on the 1920x1080 camera rays of the raster cells' view (the
   atmosphere pass's call, one origin for every ray): against the plain
   loop on the same rays with the sky on and off (every channel within
   2e-6 + 1e-5 |plain|, NaN where the plain loop is NaN; the largest
   difference and the bit-equal share), the launch counter (one launch and
   every ray a call), its device time against its bound, the plain loop's
   ms by events;
13. a tree deeper than K1's stack takes (nested shells, wide depth > 14):
   the hit queries send it to K2, which matches the plain walk;
14. RASTERIZED main path: Application(1920, 1080, RASTERIZED), default
   StaticConfig (4 shadow cascades of 4096^2, 512^2 cubemap; RT shadows
   seeded), marching cubes on, 4 frames; launch counts, frame times (frame
   1, which captures the environment, apart), per-pass times of one more
   frame; then its device loop (`raster_loop`): run_on_device(4) captured
   once (the binning in static shapes, no host read) against a host frame,
   a call of pure replay under torch.cuda.set_sync_debug_mode("error"),
   launches (first call two frames' worth, replay none), the host loop's
   and the replay's ms per frame in turns, and the busy share of each;
   then the deferred kernel (`deferred_phase`) on the inputs of the
   Sponza-scale scene's 1080p deferred pass, rows planted in every cascade:
   against the plain body under every toggle with 0, 3 and 10 lights
   (every channel within 1e-5 x max(1, |plain|)), its device time against
   its byte bound, the plain body's ms, its registers and spills, one
   launch a host frame and a kernel record a replay; then the SSAO kernels
   (`ssao_phase`) on the inputs of the same scene's 1080p SSAO pass:
   against the plain body with the pass's select off, 0 and 1 (bit for
   bit), the call's device time and each kernel's against its operations
   bound, the plain body's ms, registers and spills, two launches a host
   frame and two kernel records a replay;
15. MINIMAL main path: the same at 1920x1080, its device loop as
   RASTERIZED's; then the pass uniforms
   (`uniforms_phase`): the RASTERIZED (marching cubes on) and MINIMAL
   frames at 1920x1080 with the builders' uniforms against the same frames
   with each value a literal copied to the card in the pass body, built in
   the same run (bit-equal, launches a frame), a frame after the SSAO
   radius and FXAA threshold changed between builds against a graph built
   with them, host-to-device copies of a steady frame of each form
   (torch.profiler), frame ms of the two in turns;
16. K4 against its plain version on the 4 cascades of the default scene at
   4096^2 (bit for bit) and against the float64 interpolation at its own
   coverage (`depth_exact`: within K4_EXACT_ATOL on every covered texel,
   the same coverage), with its work plan (items, the longest item's
   rows), the (row, pixel) box pairs it tests and the share of (tile,
   global row) pairs the boxes cull; and K5 on the marching-cubes front at
   1920x1080 over the gbuffer depth, with its plan and box pairs; times on
   the device alone and by events, global-list lengths, longest segments
   and bounds; the binning of each cascade and of the marching-cubes front,
   the library's (csrc/raster_bin.cu) against its plain version (`tri_rows`
   + `bin_triangles`): every field of the Bins bit for bit, K4 over both
   bit-equal, each one's device ms alone and by events and records a
   call, and the bytes of the static tables it makes a call;
17. raster parity: one small RASTERIZED frame with marching cubes on the CPU
   (brute rasterizer, plain walk) and on the card (K4, K5, K1, the seed
   kernel);
18. raster visibility: the gbuffer pass's raster branch
   (`setup_gbuffer_pass(use_raycast=False)`: K5 over the default scene,
   `gbuffer.from_visibility`) at 1920x1080, 3 frames (K5 once a frame,
   nothing else), ms beside the ray-cast gbuffer; at 96x96 its planes
   against the CPU's pieces with K5's plain version, and beside the CPU's
   pass (brute rasterizer) with the pixels where the two rasterizers pick
   another triangle and the depth gap there;
19. the bench's other scenes at its sizes and settings: RTIOW PT at
   256x256, the cube scene RASTERIZED at 512x512, the 128-light scene PT at
   1920x1080 (per-pass ms): ms per frame of the host loop and of
   run_on_device, launches a frame, pt_rays;
20. golden gates (tests/test_pathtrace_golden.py's, on the card): RTIOW at
   256x256 and the Cornell stand-in at 128x128, 96 frames of 1 spp through
   one captured run_on_device call, against tests/golden/*.npy (8x8-block
   RMSE < 0.01, a 1.5% bias caught, region energies, wall colours);
21. furnace test: a small PT frame of the RTIOW scene's four spheres with
   StaticConfig(furnace_test=True) and the sky, sun and lights off, on the
   card and on the CPU: the frames agree and the top row (the sky) is 1.0;
22. the application's own entry point (`app/main.py::main`, called
   in-process by its command line): --sanitize at 1920x1080, 4 frames, for
   PT, RASTERIZED and MINIMAL on the default scene and PT on the RTIOW
   scene at 256x256: launches a frame, the sanitizer's report, the written
   image (PNG, or PPM where PIL is missing) decoded at the frame's size,
   the profiler's top scopes; on the PT app, a host frame with the
   sanitizer off and on, run(8) with present_every 1 and 4, and a frame
   with the profiler's timers on and off, each pair in turns, and one
   scope's host cost; a sanitized run_on_device(4) captured, its summed
   report equal to 4 host frames', and its replay against a twin's with
   the sanitizer off, in turns; the metal sphere moved by
   set_instance_transform: the next host frame bit-equal to a fresh app's
   with the sphere there, the next loop captured anew and bit-equal to the
   host loop; a glTF written to a temporary directory rendered bit-equal
   to the same scene built from ModelLoader primitives;
23. row bands on torch.distributed (`parallel/`, `Graph.shard_image_rows`;
   `tiles_phase`), every rank a process of its own and all of them on the
   one card (not a scaling figure): the PT Application's first 2 frames at
   1920x1080, flagship_step over their views from the same zero state and
   render_flagship_tiled over a one-rank NCCL group (bit-equal, and each
   bit-equal to the Application's frames); then 2 and 4 gloo ranks
   over CUDA tensors (rank 0's gathered output and spatial Y against one
   rank: bit-equal; per rank the frame ms, 6 + 5 K1
   and 5 seed launches a frame, 2 x 16 B x H x W gathered a frame, the time
   of a gather); on the 2 ranks the PT, RASTERIZED (marching cubes on) and
   MINIMAL Applications with row-sharded graphs, gathered against one rank
   (bit-equal), with per-rank frame ms and
   launches, and the row-sharded PT app's run_on_device on each gloo rank
   (eager, bit-equal to its host loop), and the row-sharded RASTERIZED
   (marching cubes on) app's the same; on the one-rank NCCL group, the
   row-sharded PT and RASTERIZED apps' device loops captured with their
   collectives and bit-equal to 4 host frames, with replay ms. The kernels
   are built before the ranks start; each rank loads them.

Each main path is driven with every launch count set to 0 just before it
and read just after; the sky kernel's is checked too (2 a RASTERIZED
frame, 5 an exact-sky PT frame, none on a cubemap-sky PT or MINIMAL frame;
the environment's capture, once an app, apart), the deferred kernel's
(1 a RASTERIZED frame, none on a PT or MINIMAL frame) and the SSAO
kernels' (2 a RASTERIZED frame, none on a PT or MINIMAL frame). Every failed check raises. The last log line gives
the script's total seconds. Exits non-zero, printing no
result, when torch sees no GPU. The last line is {"ok": true, ...}.
"""

from __future__ import annotations

import collections
import concurrent.futures
import functools
import itertools
import json
import re
import subprocess
import sys
import time

import numpy as np
import torch

WIDTH, HEIGHT, BOUNCES, FRAMES = 1920, 1080, 5, 4
PARITY_SIZE, PARITY_FRAMES, PARITY_TIME = 128, 2, 0.25
RASTER_PARITY_SIZE = 96
FURNACE_SIZE = 64
TPU = "rust_renderer_tpu/ops/pallas/traversal.py"
CSRC = "rust_renderer_tpu_torch/csrc"
# kernel -> (source, the TPU kernel it replaces)
SOURCES = {
    "k1": (f"{CSRC}/traverse_wide.cu", f"{TPU}:1568"),
    "k1q": (f"{CSRC}/traverse_q32.cu", f"{TPU}:1242"),
    "k2_sd": (f"{CSRC}/traverse_drain.cu", f"{TPU}:823"),
    "k2_sdd": (f"{CSRC}/traverse_drain.cu", f"{TPU}:1008"),
    "k3_binary": (f"{CSRC}/traverse_binary.cu", f"{TPU}:173"),
    "k3_binary_ordered": (f"{CSRC}/traverse_binary.cu", f"{TPU}:264"),
    "k3_wide": (f"{CSRC}/traverse_wide.cu", f"{TPU}:403"),
    "k3_wide_ordered": (f"{CSRC}/traverse_wide.cu", f"{TPU}:403"),
    "k3_wide_dual": (f"{CSRC}/traverse_wide.cu", f"{TPU}:2080"),
    "k3_wide_lq": (f"{CSRC}/traverse_lq.cu", f"{TPU}:620"),
    "k3_wide_multi": (f"{CSRC}/traverse_multi.cu", f"{TPU}:2296"),
    # No TPU kernel: XLA fused make_seed_test's tensor code.
    "seed": (f"{CSRC}/seed_occlusion.cu", "rust_renderer_tpu/ops/bvh.py:843"),
    # No TPU kernel: XLA fused integrate_scattering's tensor code.
    "sky": (f"{CSRC}/atmosphere.cu", "rust_renderer_tpu/ops/atmosphere.py:104"),
    # No TPU kernel: XLA fused the deferred pass's tensor code.
    "deferred": (f"{CSRC}/deferred.cu", "rust_renderer_tpu/renderers/passes.py:308"),
    # No TPU kernel: XLA fused ssao_stencil's tensor code.
    "ssao": (f"{CSRC}/ssao.cu", "rust_renderer_tpu/ops/ssao.py:150"),
    "k4": (f"{CSRC}/raster_binned.cu", "rust_renderer_tpu/ops/raster_binned.py:258"),
    "k5": (f"{CSRC}/raster_binned.cu", "rust_renderer_tpu/ops/raster_binned.py:304"),
}
# traverse() option sets, by label: the kernel each selects and its options
# (any-hit fronts add drain_first to K2's dual form, as make_any_hit does).
# K3-lq runs at two flush sizes, K3-multi at three widths.
VARIANTS = {
    "k1": ("k1", dict()),
    "k1q": ("k1q", dict(q32=True)),
    "k2_sd": ("k2_sd", dict(row_cursors=0)),
    "k2_sdd": ("k2_sdd", dict(row_cursors=0, dual=True)),
    "k3_binary": ("k3_binary", dict(wide=False)),
    "k3_binary_ordered": ("k3_binary_ordered", dict(wide=False, ordered=True)),
    "k3_wide": ("k3_wide", dict(row_cursors=0, steady_drain=0)),
    "k3_wide_ordered": ("k3_wide_ordered", dict(row_cursors=0, steady_drain=0, ordered=True)),
    "k3_wide_dual": ("k3_wide_dual", dict(row_cursors=0, steady_drain=0, dual=True)),
    "k3_wide_lq4": ("k3_wide_lq", dict(row_cursors=0, steady_drain=0, leaf_queue=4)),
    "k3_wide_lq8": ("k3_wide_lq", dict(row_cursors=0, steady_drain=0, leaf_queue=8)),
    "k3_wide_multi2": ("k3_wide_multi", dict(row_cursors=0, multi=2)),
    "k3_wide_multi4": ("k3_wide_multi", dict(row_cursors=0, multi=4)),
    "k3_wide_multi8": ("k3_wide_multi", dict(row_cursors=0, multi=8)),
}
# The option set whose times stand for a kernel in the kernels line.
LINE_VARIANT = {"k3_wide_lq": "k3_wide_lq4", "k3_wide_multi": "k3_wide_multi4"}
T_RTOL = 1e-5
VIS_ATOL = 1e-5
# Kernels whose walk tests every child box of a node before any leaf: with
# best_t tightened later, they may return a hit that lies outside its own
# leaf box where the plain walk culls that box (`outside_own_box`). At most
# this many such rays per front pass. K3-lq defers its leaves; K3-multi walks
# K3 wide's walk per ray (and is held to K3 wide's hits bit for bit).
OUTSIDE_BOX_KERNELS = ("k1q", "k2_sd", "k2_sdd", "k3_wide", "k3_wide_ordered",
                       "k3_wide_dual", "k3_wide_lq", "k3_wide_multi")
OUTSIDE_BOX_MAX = 4
# The card's peaks (H100 SXM data sheet: 67 TFLOP/s in f32 counts an FMA as
# two operations). The kernels are built with -fmad=false, so each counted
# operation is an instruction of its own: half that rate.
F32_OPS = 67e12 / 2
HBM_BYTES_S = 3.35e12
# K2's leaf queue with no cap in effect on these fronts (checked per run).
K2_QUEUE_UNCAPPED = 1024
# Operations of one test, counted in the code (csrc/traverse_common.cuh):
# a slab test is 6 sub + 6 mul + 11 min/max + 2 compares; a Moller-Trumbore
# slot 9 + 5 (d x e2, det) + 1 compare + 1 div + 3 + 6 (u) + 9 (q) + 6 (v)
# + 6 (t) + 1 add + 5 compares.
BOX_TEST_OPS = 25
TRI_TEST_OPS = 52
# The seed kernel's test (csrc/seed_occlusion.cu) by the stage it ends at:
# the determinant (|det| <= 1e-12: the 9 + 5 + 1 operations up to that
# compare); u out of [0, 1] (+ 1 div + 3 + 6 + 2 compares); v or u + v
# (+ 9 + 6 + 1 add + 2 compares); t (+ 6 + 2 compares).
SEED_DET_OPS, SEED_U_OPS, SEED_V_OPS, SEED_T_OPS = 15, 27, 45, 53
# K4 / K5 per (row, pixel) test (csrc/raster_binned.cu): 3 edges x 3 ops, 3
# compares, the depth plane from the first vertex 6 (2 offsets, 2 products,
# 2 sums), the depth compare / select 2.
K4_PAIR_OPS = 20
K5_PAIR_OPS = 20
# K4's largest gap to the float64 interpolation on a covered texel.
K4_EXACT_ATOL = 1e-5
# The sky kernel's operations a ray (csrc/atmosphere.cu in sky_radiance's
# form), counted in the code: 73 float32 operations, 2 sqrtf and 3 divisions
# before the march; 16 view samples of 367 operations, 10 sqrtf, 24 expf, a
# division and a powf each (an 8-sample light march of 273 operations, 9
# sqrtf, 16 expf and a division among them); 24 after. A library call counts
# as its instruction sequence: expf, sqrtf and a correctly rounded division 8
# each, powf 32.
SKY_LIB_OPS = {"expf": 8, "sqrtf": 8, "div": 8, "powf": 32}
SKY_OPS_PER_RAY = (
    73 + 2 * SKY_LIB_OPS["sqrtf"] + 3 * SKY_LIB_OPS["div"]
    + 16 * (367 + 10 * SKY_LIB_OPS["sqrtf"] + 24 * SKY_LIB_OPS["expf"] + SKY_LIB_OPS["div"]
            + SKY_LIB_OPS["powf"])
    + 24)
# Origin and direction read, the color written.
SKY_BYTES_PER_RAY = 24 + 12
# The deferred kernel's bytes a pixel (csrc/deferred.cu): the four gbuffer
# planes and the reflections read (16 B each), the RT shadows and SSAO (4 B
# each), the output written (16 B).
DEFERRED_BYTES_PER_PIXEL = 5 * 16 + 2 * 4 + 16
# The deferred kernel against its plain version: every channel within
# DEFERRED_RTOL x max(1, |plain|).
DEFERRED_RTOL = 1e-5
DEFERRED_TOGGLES = ("ibl_enabled", "shadows_enabled", "raytracing_supported",
                    "cascade_debug", "ssao_enabled")
# The deferred phase's rows planted with positions in every cascade.
DEFERRED_PLANTED_ROWS = slice(700, 764)
# The SSAO kernels' operations a pixel (csrc/ssao.cu), counted in the code,
# every sample taken (a "tiny" one skips 24 of its operations, atan2f, log2f
# and a division): 96 float32 operations, 2 sqrtf and 8 divisions before the
# samples (view-space position and normal, the TBN, the pixel's NDC); 32
# samples of 95 operations (the sample point 21, its NDC 26, the offset and
# radius 8, the sector, ring and tap 24, the range check 16), 3 divisions, a
# sqrtf, an atan2f and a log2f each; 4 after. A library call counts as its
# instruction sequence: sqrtf and a correctly rounded division 8 each, log2f
# 16, atan2f 24.
SSAO_LIB_OPS = {"sqrtf": 8, "div": 8, "log2f": 16, "atan2f": 24}
SSAO_OPS_PER_PIXEL = (
    96 + 2 * SSAO_LIB_OPS["sqrtf"] + 8 * SSAO_LIB_OPS["div"]
    + 32 * (95 + 3 * SSAO_LIB_OPS["div"] + SSAO_LIB_OPS["sqrtf"] + SSAO_LIB_OPS["atan2f"]
            + SSAO_LIB_OPS["log2f"])
    + 4)
# Their bytes a pixel: the depth kernel reads the position (16 B) and
# writes the view depth (4 B); the occlusion kernel reads the position and
# the normal (32 B), the depth plane once from memory (4 B; its 32 taps a
# pixel hit in L2) and writes the occlusion (4 B).
SSAO_BYTES_PER_PIXEL = 16 + 4 + 32 + 4 + 4
# The raster cells' view (bench_torch/configs/raster_rtshadows_sponza_1080p.json).
SKY_VIEWPOINT, SKY_TARGET = [-10.28, 2.10, -0.18], [0.0, 0.5, 0.0]
# The bench's Sponza-scale configuration (bench.py:101-105).
SPONZA_CFG = dict(num_bounces=BOUNCES, samples_per_frame=1, sky_mode="cubemap",
                  cubemap_size=256, cubemap_mips=8, irradiance_size=32,
                  brdf_lut_size=128)
DEEP_LEVELS, DEEP_PER, DEEP_RATIO, DEEP_SIZE = 20, 200, 0.3, 1e4
# The PT frame's compaction windows (StaticConfig.compact_window and
# compact_window_any, in ray blocks) and seed rows.
COMPACT_CLOSEST, COMPACT_ANY, SEED_ROWS = 64, 128, 4
SCHEDULES_OFF = dict(compact_window=0, compact_window_any=0, seed_rows=0)
SCHEDULE_PAIRS = 3
# Kernel timing: cycles the card spins per timed call before a timed run
# (~0.5 ms at the H100's 1.98 GHz; `device_ms` checks that the spin outlasts
# the host's enqueueing, and lengthens it if not), and rounds of TIMING_REPS
# calls per kernel and front, in turns.
SPIN_CYCLES_PER_CALL = 1_000_000
TIMING_ROUNDS, TIMING_REPS = 3, 5
# The device loop: frames a call, and the largest |diff| from the host loop
# that passes (0 is expected: no float atomic is on the PT path). The golden
# gates' frames and bounces (tests/test_pathtrace_golden.py).
LOOP_FRAMES, LOOP_ATOL = 4, 1e-6
# Turns of the raster apps' host loop against their replay (`raster_loop`).
RASTER_TURNS = 3
# Frames in the window whose device busy share is read: LOOP_FRAMES, since a
# graph with an isolated prefix (config 5) stacks its tables over the N
# frames of a call, so another N captures anew.
PROFILED_FRAMES = LOOP_FRAMES
GOLD_FRAMES, GOLD_BOUNCES = 96, 3
# The bench's sizes of the RTIOW (PT) and cube (RASTERIZED) scenes.
RTIOW_SIZE, CUBE_SIZE = 256, 512
# The bench's config 5 (bench.py:251-253, :101-111): the default scene with
# the traced marching-cubes isosurface at the bench's PT settings, mc_grid
# 32; frames with MC on and off in turns; the parity frame's size, clock
# and camera (on the MC region, tests/test_mc_pt.py:173).
MC_CFG = dict(SPONZA_CFG, mc_grid=32)
MC_TURNS = 3
MC_PARITY_SIZE, MC_TIME = 128, 1.7
MC_EYE, MC_TARGET = [58.0, 38.0, 58.0], [10.0, 18.0, 10.0]


START = time.perf_counter()


def log(*args) -> None:
    """A line of the report, stamped with the seconds since the start."""
    print(f"[{time.perf_counter() - START:6.1f} s]", *args, flush=True)


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


def timed(fn) -> tuple:
    """fn()'s result and its milliseconds, by CUDA events around one call."""
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def device_ms(fn, reps: int) -> float:
    """Mean device milliseconds of fn() over `reps` back-to-back calls: the
    card spins first (torch.cuda._sleep) while the host enqueues them all,
    so the host's time between two launches is not counted. The start event
    must still be pending once the host has enqueued the last call (else the
    card may have waited on the host); the spin is lengthened until it is."""
    cycles = SPIN_CYCLES_PER_CALL * reps
    for _ in range(4):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        covered = not start.query()
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(stop) / reps
        cycles *= 4
    raise AssertionError("device_ms: the host enqueued the calls slower than the card spun")


class Launches:
    """The kernels' launch counters: zeroed before a main path, read after.

    The sky kernel's count ("sky") is the frames' own: the launch that the
    environment's capture makes (ibl.capture_environment_cubemap, once when
    a RASTERIZED or cubemap-sky PT app first reads the cubemaps: set-up, not
    a frame's work) is counted apart and left out. The deferred kernel's
    ("deferred") is one a RASTERIZED frame, the SSAO kernels' ("ssao")
    RASTER_SSAO; the binning library's ("bin") BIN_CALL a K4 or K5 call. A port
    without the sky, the deferred or the SSAO kernels' or the binning's
    counter (a parent checkout under `--raster`) reads no "sky", "deferred",
    "ssao" or "bin"."""

    K3_VARIANTS = ("binary", "binary_ordered", "wide", "wide_ordered", "wide_dual",
                   "wide_lq", "wide_multi")

    def __init__(self, traversal, raster_binned, bvh_ops):
        from rust_renderer_tpu_torch.ops import atmosphere, ibl

        self.traversal, self.raster_binned, self.bvh_ops = traversal, raster_binned, bvh_ops
        self.bin = hasattr(raster_binned, "BIN_LAUNCHES")
        self.sky = getattr(atmosphere, "SKY_LAUNCHES", None)
        try:
            from rust_renderer_tpu_torch.ops import deferred
            self.deferred = deferred.DEFERRED_LAUNCHES
        except ImportError:
            self.deferred = None
        from rust_renderer_tpu_torch.ops import ssao
        self.ssao = getattr(ssao, "SSAO_LAUNCHES", None)
        if self.sky is not None and not hasattr(ibl.capture_environment_cubemap, "sky"):
            ibl.capture_environment_cubemap = Launches._counting_capture(
                ibl.capture_environment_cubemap, self.sky)
        self.capture = ibl.capture_environment_cubemap

    @staticmethod
    def _counting_capture(capture, sky):
        """capture_environment_cubemap, keeping the sky launches it makes in
        its attribute `sky` (once a process: every Launches reads it)."""
        def counted(*args, **kw):
            before = sky["launches"]
            try:
                return capture(*args, **kw)
            finally:
                counted.sky += sky["launches"] - before

        counted.sky = 0
        return counted

    def reset(self) -> None:
        for counter in (self.traversal.K1_LAUNCHES, self.traversal.K1Q_LAUNCHES,
                        self.traversal.K2_LAUNCHES, self.traversal.K3_LAUNCHES):
            counter.clear()
        self.raster_binned.K4_LAUNCHES = 0
        self.raster_binned.K5_LAUNCHES = 0
        if self.bin:
            self.raster_binned.BIN_LAUNCHES = 0
        self.bvh_ops.SEED_LAUNCHES = 0
        if self.sky is not None:
            self.sky.clear()
            self.capture.sky = 0
        if self.deferred is not None:
            self.deferred.clear()
        if self.ssao is not None:
            self.ssao.clear()

    def read(self) -> dict:
        t = self.traversal
        got = {"k1_closest": t.K1_LAUNCHES["closest"], "k1_any_hit": t.K1_LAUNCHES["any_hit"],
               "k1q": sum(t.K1Q_LAUNCHES.values()),
               "k4": self.raster_binned.K4_LAUNCHES, "k5": self.raster_binned.K5_LAUNCHES,
               "seed": self.bvh_ops.SEED_LAUNCHES}
        for variant in ("sd", "sdd"):
            got[f"k2_{variant}"] = t.K2_LAUNCHES[variant]
        for variant in Launches.K3_VARIANTS:
            got[f"k3_{variant}"] = t.K3_LAUNCHES[variant]
        if self.bin:
            got["bin"] = self.raster_binned.BIN_LAUNCHES
        if self.sky is not None:
            got["sky"] = self.sky["launches"] - self.capture.sky
        if self.deferred is not None:
            got["deferred"] = self.deferred["launches"]
        if self.ssao is not None:
            got["ssao"] = self.ssao["launches"]
        return got

    @staticmethod
    def frame_want(k1_closest: int, k1_any_hit: int, k4: int, k5: int, seed: int = 0,
                   sky: int = 0, deferred: int = 0, ssao: int = 0) -> dict:
        """Per-frame counts of a frame: K1, K4, K5, the seed kernel, the sky
        kernel, the deferred kernel and the SSAO kernels as given, the binning
        library's BIN_CALL a K4 or K5 call, 0 on every other kernel."""
        want = dict.fromkeys(
            ("k1q", "k2_sd", "k2_sdd", *(f"k3_{v}" for v in Launches.K3_VARIANTS)), 0)
        want.update(k1_closest=k1_closest, k1_any_hit=k1_any_hit, k4=k4, k5=k5,
                    bin=BIN_CALL * (k4 + k5), seed=seed, sky=sky, deferred=deferred, ssao=ssao)
        return want


# The sky kernel's launches in a RASTERIZED frame (ray-traced passes on):
# the atmosphere pass and the reflections' misses, each over every pixel;
# in a PT frame with the exact sky (the StaticConfig default), BOUNCES
# bounces and one sample: the miss shader's, once a bounce. A PT frame with
# the cubemap sky (SPONZA_CFG, MC_CFG), a MINIMAL frame and the furnace
# test launch it never.
RASTER_SKY, PT_SKY = 2, BOUNCES
# The SSAO kernels' launches a RASTERIZED frame: the depth plane, then the
# occlusion.
RASTER_SSAO = 2
# The binning library's launches a K4 or K5 call: setup, hist, colscan,
# tilescan, fill.
BIN_CALL = 5
# A RASTERIZED frame's launches of the seed, sky, deferred and SSAO kernels
# (K1, K4 and K5 apart).
RASTER_FRAME = dict(seed=1, sky=RASTER_SKY, deferred=1, ssao=RASTER_SSAO)


# Config 5's launches a frame: K1 on the scene's tree and on the dynamic tree
# for every query, the seed test on the scene's tree only.
MC_WANT = Launches.frame_want(2 * (1 + BOUNCES), 2 * BOUNCES, 0, 0, seed=BOUNCES)


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
    return got, steady


def pt_schedules(label, app, launches, counted, sky: int) -> None:
    """The PT main path at the StaticConfig defaults (compaction windows and
    the seed test on), then frames with the four fields off, at the
    defaults, and with only the seed test off, in turns (SCHEDULE_PAIRS of
    each; frame times drift across a call, so they are compared in turns):
    launch counts (K1's unchanged; the seed kernel once per any-hit front
    when on; the sky kernel `sky` a frame), the medians and their ratios."""
    per_frame = dict(k1_closest=1 + BOUNCES, k1_any_hit=BOUNCES, k4=0, k5=0, sky=sky)
    counted.update(run_frames(label, app, launches,
                              Launches.frame_want(**per_frame, seed=BOUNCES))[0])
    cfgs = {"off": app.cfg.replace(**SCHEDULES_OFF), "on": app.cfg,
            "seed_off": app.cfg.replace(seed_rows=0)}
    times = {k: [] for k in cfgs}
    for i in range(len(cfgs) * SCHEDULE_PAIRS):
        key = list(cfgs)[i % len(cfgs)]
        app.cfg = cfgs[key]
        launches.reset()
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        app.render_frame()
        stop.record()
        torch.cuda.synchronize()
        times[key].append(start.elapsed_time(stop))
        got = launches.read()
        want = Launches.frame_want(**per_frame, seed=BOUNCES if key == "on" else 0)
        if got != want:
            raise AssertionError(f"{label} (schedules {key}): launches {got}, expected {want}")
        counted.update(got)
    app.cfg = cfgs["on"]
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f"{label}: frames in turns, off / on / seed off: "
        + " / ".join(str([round(x, 2) for x in times[k]]) for k in cfgs)
        + f" ms; median at the StaticConfig defaults {med['on']:.1f} ms, with compact_window, "
        f"compact_window_any and seed_rows 0 {med['off']:.1f} ms (ratio "
        f"{med['on'] / med['off']:.3f}), with seed_rows 0 only {med['seed_off']:.1f} ms "
        f"(seed_rows 4 vs 0: ratio {med['on'] / med['seed_off']:.3f})")


def pass_times(label: str, app, times: dict | None = None) -> dict:
    """One more frame with CUDA events around every pass body; returns each
    pass's outputs, and appends each pass's ms to times[name] where
    `times` is given."""
    app._refresh_view()
    app._ensure_environment()
    app._build_graph()
    events, outputs = [], {}
    for p in app.graph.passes:
        # *u: the uniforms, where the pass was built with a body that takes them.
        def timed(res, scene, view, *u, fn=p.fn, name=p.name):
            start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            outputs[name] = fn(res, scene, view, *u)
            stop.record()
            events.append((name, start, stop))
            return outputs[name]
        p.fn = timed
    app.graph.render(app.scene, app.view)
    torch.cuda.synchronize()
    log(f"{label} per-pass ms: " + ", ".join(
        f"{name} {a.elapsed_time(b):.2f}" for name, a, b in events))
    for name, a, b in events:
        if times is not None:
            times.setdefault(name, []).append(a.elapsed_time(b))
    return outputs


# -- PT (unchanged phases) -----------------------------------------------------


def outside_own_box(bvh, ray, t, prim) -> bool:
    """Whether (t, prim) is the Moller-Trumbore hit of triangle `prim` (its
    t recomputed bit for bit from the leaf table, as the walks compute it)
    at a point the slab test of its binary leaf node puts beyond the box
    (tnear > t). Such a hit is ill-conditioned: a walk tests it only if
    best_t is still above tnear when the box is tested, so walks that
    tighten best_t in another order may return it or the next hit."""
    o, d, t_min = ray
    ls = bvh.leaf_packed.shape[1] // 10
    ids = bvh.leaf_packed[:, 9 * ls:].contiguous().view(torch.int32)
    node_i = bvh.node_packed.view(torch.int32)
    inv = 1.0 / torch.where(d.abs() < 1e-12, torch.where(d < 0, -1e-12, 1e-12), d)
    for row, slot in torch.nonzero(ids == prim).tolist():
        v0, e1, e2 = bvh.leaf_packed[row, 9 * slot:9 * slot + 9].reshape(3, 3)
        p = torch.stack([d[1] * e2[2] - d[2] * e2[1], d[2] * e2[0] - d[0] * e2[2],
                         d[0] * e2[1] - d[1] * e2[0]])
        inv_det = 1.0 / (e1[0] * p[0] + e1[1] * p[1] + e1[2] * p[2])
        tv = o - v0
        q = torch.stack([tv[1] * e1[2] - tv[2] * e1[1], tv[2] * e1[0] - tv[0] * e1[2],
                         tv[0] * e1[1] - tv[1] * e1[0]])
        t_tri = (e2[0] * q[0] + e2[1] * q[1] + e2[2] * q[2]) * inv_det
        if not (bool(t_tri == t) and bool(t_tri > t_min)):
            continue
        for n in torch.nonzero(node_i[:, 7] == row).flatten().tolist():
            box = bvh.node_packed[n]
            t0, t1 = (box[0:3] - o) * inv, (box[3:6] - o) * inv
            if bool(torch.minimum(t0, t1).max() > t):
                return True
    return False


def compare_hits(label, got, plain, any_hit, bvh=None, ray=None) -> tuple[float, int]:
    """Raise unless a kernel and the plain walk agree: hit flags equal; for
    closest hits t to T_RTOL relative and prim equal off ties. With `bvh`
    and `ray` (o, d, t_min), for a kernel of OUTSIDE_BOX_KERNELS, up to
    OUTSIDE_BOX_MAX rays where the kernel returns a nearer hit that lies
    outside its own leaf box (`outside_own_box`) are counted, not failures.
    Returns max |t| error over the agreeing rays and that count."""
    tk, pk = got[0], got[1]
    tp, pp = plain[0], plain[1]
    hk, hp = pk >= 0, pp >= 0
    if not torch.equal(hk, hp):
        raise AssertionError(f"{label}: hit flags differ on {int((hk != hp).sum())} rays")
    if any_hit:
        return 0.0, 0
    both = hk & hp
    diff = (tk - tp).abs()
    tie = diff <= T_RTOL * tp.abs()
    bad = torch.nonzero(both & ~tie).flatten().tolist()  # t or prim off a tie
    if bvh is not None and len(bad) > OUTSIDE_BOX_MAX:
        raise AssertionError(f"{label}: {len(bad)} rays off the plain walk's hits")
    explained = []
    for i in bad:
        if bvh is None or not bool(tk[i] < tp[i]) or not outside_own_box(
                bvh, (ray[0][i], ray[1][i], ray[2][i]), tk[i], int(pk[i])):
            raise AssertionError(
                f"{label}: ray {i} t {float(tk[i])} prim {int(pk[i])} against the plain "
                f"walk's t {float(tp[i])} prim {int(pp[i])}")
        explained.append(i)
    if explained:
        log(f"{label}: {len(explained)} ray(s) where the kernel returns a nearer hit that lies "
            f"outside its own leaf box (the plain walk culls that box): "
            + "; ".join(f"ray {i} t {float(tk[i])} prim {int(pk[i])} vs t {float(tp[i])} "
                        f"prim {int(pp[i])}" for i in explained))
    keep = both.clone()
    keep[explained] = False
    err = diff[keep]
    return (float(err.max()) if err.numel() else 0.0), len(explained)


def make_fronts(app, traversal, rays, pathtrace, dyn=None) -> dict:
    """The 1080p primary, bounce and NEE any-hit fronts of app's scene:
    name -> (o, d, t_min, t_max, any_hit). With `dyn` (an ops/mc_bvh.py
    DynamicScene), the primary hit is the nearer of the scene's and the
    dynamic tree's, as config 5's frame finds it."""
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
    t_hit = traversal.traverse_plain(bvh.node_packed, bvh.leaf_packed, o, d, t_min,
                                     t_max, False)[0]
    if dyn is not None:
        t_hit = torch.minimum(t_hit, traversal.traverse_plain(
            dyn.bvh.node_packed, dyn.bvh.leaf_packed, o, d, t_min, t_max, False)[0])
    hit = t_hit < rays.INF
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
    return {
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


def k1_phase(app, traversal, fronts) -> dict:
    """K1 against the plain walk on 1080p fronts of the default scene. The
    plain walk runs once per front (timed by CUDA events); its hits and
    time are returned under "plain" for the variants phase."""
    bvh = app.scene_bvh
    result = {"max_abs_err": 0.0, "plain": {}}
    for name, (fo, fd, fmin, fmax, any_hit) in fronts.items():
        k1 = lambda: traversal.traverse_wide_cuda(bvh.wnode_packed, bvh.leaf_packed,
                                                  bvh.wide_depth, fo, fd, fmin, fmax,
                                                  any_hit)
        want, plain_ms = timed(lambda: traversal.traverse_plain(
            bvh.node_packed, bvh.leaf_packed, fo, fd, fmin, fmax, any_hit))
        result["plain"][name] = (want, plain_ms)
        got = k1()
        torch.cuda.synchronize()
        err = compare_hits(name, got, want, any_hit)[0]
        k1()  # warm-up
        k1_ms = cuda_ms(k1, 20)
        k1_device_ms = device_ms(k1, 20)
        live = int((fd * fd).sum(dim=1).gt(0).sum())
        log(f"kernel K1 front={name} rays={fd.shape[0]} live={live} "
            f"hits={int((got[1] >= 0).sum())} max_abs_err_t={err:.3e} "
            f"k1_ms={k1_ms:.4f} (device alone {k1_device_ms:.4f}) plain_ms={plain_ms:.3f}")
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


# -- traversal variants ----------------------------------------------------------


def table_bytes(bvh, kernel: str) -> int:
    """Bytes of the tables `kernel` reads."""
    if kernel == "k1q":
        tables = (bvh.wnode_q32, bvh.wnode_meta32, bvh.q32_leaf_perm, bvh.leaf_packed)
    elif kernel.startswith("k3_binary"):
        tables = (bvh.node_packed, bvh.leaf_packed)
    else:
        tables = (bvh.wnode_packed, bvh.leaf_packed)
    return sum(t.numel() * t.element_size() for t in tables)


def walk_counts(traversal, bvh, front) -> dict:
    """The child-box slab tests and triangle tests of a walk of `front`, as
    K3's stats count them per ray (the walk K1 does over the same tree,
    with leaves popped instead of tested inline; empty slots are skipped),
    and their operations."""
    fo, fd, fmin, fmax, any_hit = front
    stats = traversal.traverse(bvh, fo, fd, fmin, fmax, any_hit=any_hit,
                               **VARIANTS["k3_wide"][1], stats=True)[4]
    pops, leaf_pops, box_tests, tri_tests = (
        int(x) for x in stats.sum(dim=1, dtype=torch.int64))
    ops = box_tests * BOX_TEST_OPS + tri_tests * TRI_TEST_OPS
    return {"pops": pops, "leaf_pops": leaf_pops, "box_tests": box_tests,
            "tri_tests": tri_tests, "ops": ops, "rays": fo.shape[0],
            # every slot of every popped entry, as if no slot were empty
            "all_slots_ops": ((pops - leaf_pops) * traversal.K1_WIDTH * BOX_TEST_OPS
                              + leaf_pops * traversal.K1_LEAF_SLOTS * TRI_TEST_OPS)}


def k1_walk_counts(traversal, bvh, front) -> dict:
    """The child-box slab tests and triangle tests of K1's own walk of
    `front` (its stats form: near first, leaves tested inline, entries
    beyond the best hit dropped), their operations, and its other counts."""
    fo, fd, fmin, fmax, any_hit = front
    stats = traversal.traverse(bvh, fo, fd, fmin, fmax, any_hit=any_hit, phase_stats=True)[4]
    iterations, expanded, leaf_rows, culled, box_tests, tri_tests = (
        int(x) for x in stats.sum(dim=1, dtype=torch.int64))
    # K1 walks ray i in lane i % 32 of warp i // 32, and a warp iterates as
    # long as its longest walk: the share of its lanes' iterations that work.
    per_warp = torch.nn.functional.pad(stats[0], (0, -fo.shape[0] % 32)).view(-1, 32)
    warp_iterations = int(per_warp.max(dim=1).values.sum(dtype=torch.int64)) * 32
    return {"iterations": iterations, "expanded": expanded, "leaf_rows": leaf_rows,
            "culled": culled, "box_tests": box_tests, "tri_tests": tri_tests,
            "lanes_busy": iterations / max(warp_iterations, 1),
            "ops": box_tests * BOX_TEST_OPS + tri_tests * TRI_TEST_OPS, "rays": fo.shape[0]}


def walk_bound(counts: dict, bvh, kernel: str) -> dict:
    """The least time of the walk: the larger of its operations over the
    unfused f32 rate and its bytes (rays and limits read, hits written, the
    kernel's tables read, each once) over the memory rate."""
    nbytes = counts["rays"] * (6 + 2 + 4) * 4 + table_bytes(bvh, kernel)
    ops_ms, bytes_ms = counts["ops"] / F32_OPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "bytes": nbytes,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def k2_queue(traversal, bvh, front) -> str:
    """K2's per-ray peak leaf-queue depth on `front` (stats row 2) for sd
    and sdd, with the queue uncapped and at K2_QUEUE_CAP, and the scratch
    (stack and queue) of one launch; raises if the uncapped queue filled."""
    fo, fd, fmin, fmax, any_hit = front
    walkers = traversal.k2_walkers(fo.shape[0], fo.device)
    parts = []
    for dual in (False, True):
        peaks = {}
        for cap in (K2_QUEUE_UNCAPPED, traversal.K2_QUEUE_CAP):
            peaks[cap] = traversal.traverse_drain_cuda(
                bvh.wnode_packed, bvh.leaf_packed, bvh.wide_depth, fo, fd, fmin, fmax,
                any_hit, dual=dual, drain_first=any_hit and dual, stats=True,
                queue_cap=cap)[4][2]
        free = peaks[K2_QUEUE_UNCAPPED]
        if int(free.max()) >= K2_QUEUE_UNCAPPED:
            raise AssertionError(f"K2 queue: {K2_QUEUE_UNCAPPED} rows filled")
        scratch = ((traversal.level_stack_need(bvh.wide_depth, dual) + traversal.K2_QUEUE_CAP)
                   * walkers * 4)
        parts.append(
            f"{'sdd' if dual else 'sd'}: uncapped peak max {int(free.max())} p99.9 "
            f"{float(torch.quantile(free.float(), 0.999)):.0f} mean {float(free.float().mean()):.2f}, "
            f"{int((free > traversal.K2_QUEUE_CAP).sum())} rays above the cap of "
            f"{traversal.K2_QUEUE_CAP} (capped peak max {int(peaks[traversal.K2_QUEUE_CAP].max())}), "
            f"scratch {scratch / 2**20:.1f} MiB per launch ({walkers} walkers)")
    return "; ".join(parts)


def moved_by(launches, call) -> tuple:
    """call()'s result and the launch counts it moved."""
    before = launches.read()
    out = call()
    return out, {k: v - before[k] for k, v in launches.read().items() if v != before[k]}


def variant_options(label: str, any_hit: bool) -> dict:
    kernel, options = VARIANTS[label]
    return dict(options, drain_first=any_hit and kernel == "k2_sdd")


def variants_phase(label, bvh, fronts, traversal, launches, plain=None) -> dict:
    """Every traversal option set through traverse(...) on each front,
    counted (the main path of this slice), then held against the plain walk
    (K3-multi also against K3 wide, bit for bit) and timed beside K1.
    `plain`: front -> (plain walk's hits, its ms) where already known.
    Returns per-label launches and results."""
    launches.reset()
    outputs = {}
    results = {k: {"max_abs_err": 0.0, "outside_own_box": 0, "launches": 0} for k in VARIANTS}
    for fname, (fo, fd, fmin, fmax, any_hit) in fronts.items():
        for name, (kernel, _) in VARIANTS.items():
            options = variant_options(name, any_hit)
            rule = {k: v for k, v in options.items() if k != "drain_first"}
            if traversal.select_kernel(bvh, any_hit, ray_shape=fo.shape[:-1], **rule) != kernel:
                raise AssertionError(f"{label} {fname}: options {rule} do not select {kernel}")
            outputs[fname, name], moved = moved_by(launches, functools.partial(
                traversal.traverse, bvh, fo, fd, fmin, fmax, any_hit=any_hit, **options))
            key = "k1_any_hit" if kernel == "k1" and any_hit else (
                "k1_closest" if kernel == "k1" else kernel)
            if moved != {key: 1}:
                raise AssertionError(f"{label} {fname} {name}: launches moved {moved}")
            results[name]["launches"] += moved[key]
    torch.cuda.synchronize()
    counted = launches.read()
    log(f"{label} variants launches {counted}")
    for fname, front in fronts.items():
        fo, fd, fmin, fmax, any_hit = front
        if plain and fname in plain:
            want, plain_ms = plain[fname]
        else:
            want, plain_ms = timed(lambda: traversal.traverse_plain(
                bvh.node_packed, bvh.leaf_packed, fo, fd, fmin, fmax, any_hit))
        counts = walk_counts(traversal, bvh, front)
        bound = walk_bound(counts, bvh, "k1")
        own = k1_walk_counts(traversal, bvh, front)
        own_bound = walk_bound(own, bvh, "k1")
        results["k1"].setdefault("bounds", {})[fname] = (own_bound["bound_ms"],
                                                         bound["bound_ms"], own["lanes_busy"])
        log(f"{label} front={fname} K2 leaf queue: {k2_queue(traversal, bvh, front)}")
        runs = {}
        for name, (kernel, _) in VARIANTS.items():
            got = outputs[fname, name]
            exempt = kernel in OUTSIDE_BOX_KERNELS
            err, outside = compare_hits(f"{label} {fname} {name}", got, want, any_hit,
                                        bvh if exempt else None,
                                        (fo, fd, fmin) if exempt else None)
            results[name]["outside_own_box"] += outside
            if kernel == "k3_binary" and not any_hit and not (
                    torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                raise AssertionError(f"{label} {fname}: K3 binary is not bit-equal")
            wide = outputs[fname, "k3_wide"]
            if kernel == "k3_wide_multi" and not (
                    torch.equal(got[0].view(torch.int32), wide[0].view(torch.int32))
                    and torch.equal(got[1], wide[1])):
                raise AssertionError(f"{label} {fname} {name}: not K3 wide's hits bit for bit")
            results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err)
            runs[name] = functools.partial(traversal.traverse, bvh, fo, fd, fmin, fmax,
                                           any_hit=any_hit, **variant_options(name, any_hit))
            runs[name]()  # warm-up
        times = {name: [] for name in runs}
        for i in range(TIMING_ROUNDS):
            for name in list(runs)[::1 if i % 2 == 0 else -1]:
                times[name].append(device_ms(runs[name], TIMING_REPS))
        line = []
        for name, ts in times.items():
            ms = sorted(ts)[len(ts) // 2]
            r = results[name]
            r[fname] = ms
            if fname == "primary":
                kb = own_bound if name == "k1" else walk_bound(counts, bvh, VARIANTS[name][0])
                r.update(ms=ms, plain_ms=plain_ms, bound_ms=kb["bound_ms"],
                         bound_by=kb["bound_by"])
            line.append(f"{name} {ms:.4f} ({min(ts):.4f}-{max(ts):.4f})")
        log(f"{label} front={fname} rays={fo.shape[0]} hits={int((want[1] >= 0).sum())} "
            f"plain_ms={plain_ms:.1f} (one run) pops={counts['pops']} "
            f"leaf_pops={counts['leaf_pops']} box_tests={counts['box_tests']} "
            f"tri_tests={counts['tri_tests']} K3-walk bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}: {counts['ops']:.3e} ops, every slot counted "
            f"{counts['all_slots_ops']:.3e}; {bound['bytes']:.3e} B); K1's own walk: "
            f"iterations={own['iterations']} expanded={own['expanded']} "
            f"leaf_rows={own['leaf_rows']} culled={own['culled']} box_tests={own['box_tests']} "
            f"tri_tests={own['tri_tests']} lanes_busy={own['lanes_busy']:.3f}, bound "
            f"{own_bound['bound_ms']:.4f} ms "
            f"({own_bound['bound_by']}: {own['ops']:.3e} ops); "
            f"device ms, median (range) of {TIMING_ROUNDS} rounds: " + ", ".join(line))
    return results


def k1_table(variants) -> None:
    """K1 beside K3 wide and K3 wide ordered, the yardsticks of its walk, on
    the six fronts (device ms: the variants phase's medians), K1's bound
    from its own walk's tests beside the bound from K3 wide's, and the share
    of K1's lane-iterations that do work (its warps' divergence)."""
    for scene, results in variants.items():
        for front in ("primary", "bounce", "nee_any_hit"):
            k1, wide, ordered = (results[name][front]
                                 for name in ("k1", "k3_wide", "k3_wide_ordered"))
            own, walk, busy = results["k1"]["bounds"][front]
            log(f"K1 {scene} {front}: K1 {k1:.4f}, K3 wide {wide:.4f}, K3 wide ordered "
                f"{ordered:.4f} ms; K1 / K3 wide {k1 / wide:.3f}, K1 / K3 wide ordered "
                f"{k1 / ordered:.3f}; K1's own bound {own:.4f} ms ({k1 / own:.2f}x), "
                f"K3-walk bound {walk:.4f} ms ({k1 / walk:.2f}x); lanes busy in K1's "
                f"iterations {busy:.3f}")


def nested_shells(device, traversal, bvh_ops):
    """A mesh whose wide tree is deeper than K1's stack takes: nested
    shells, each DEEP_RATIO the size of the last (SAH splits off one shell
    per level and the wide collapse keeps the rest of the nest as one child
    per wide node), and rays at every shell's scale."""
    rng = np.random.default_rng(0)
    tris = []
    for k in range(DEEP_LEVELS):
        s = DEEP_SIZE * DEEP_RATIO ** k
        c = np.stack([rng.uniform(s / 2, s, DEEP_PER), rng.uniform(0, s, DEEP_PER),
                      rng.uniform(0, s, DEEP_PER)], 1)
        e = rng.normal(0.0, s / 20, (DEEP_PER, 2, 3))
        tris.append(np.stack([c, c + e[:, 0], c + e[:, 1]], 1))
    pos = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    bvh = bvh_ops.build_bvh(pos, np.arange(len(pos)).reshape(-1, 3), device=device)
    n = WIDTH * HEIGHT
    s = DEEP_SIZE * DEEP_RATIO ** rng.integers(0, DEEP_LEVELS - 3, n)
    o = s[:, None] * rng.uniform(-0.5, 1.5, (n, 3))
    target = s[:, None] * np.stack([rng.uniform(0.5, 1, n), rng.uniform(0, 1, n),
                                    rng.uniform(0, 1, n)], 1)
    d = (target - o) / np.linalg.norm(target - o, axis=-1, keepdims=True)
    rays = [torch.tensor(x, dtype=torch.float32, device=device)
            for x in (o, d, 1e-6 * s, 4 * s)]
    return bvh, rays


def deep_tree_phase(traversal, bvh_ops, launches) -> dict:
    """A tree of wide depth > 14 through the hit queries' options: K2, not a
    refusal, and K2 against the plain walk."""
    bvh, (o, d, t_min, t_max) = nested_shells("cuda", traversal, bvh_ops)
    need = traversal.k1_stack_need(bvh.wide_depth)
    log(f"deep tree: {o.shape[0]} rays, wide depth {bvh.wide_depth} (K1 stack need {need} > "
        f"{traversal.K1_STACK_CAP}), binary depth {bvh.max_depth}, "
        f"{bvh.wnode_packed.shape[0]} wide nodes")
    if need <= traversal.K1_STACK_CAP:
        raise AssertionError("deep tree: K1 would take this tree")
    launches.reset()
    outputs = {}
    for any_hit in (False, True):
        options = dict(dual=True, drain_first=any_hit)  # make_*_hit's defaults
        if traversal.select_kernel(bvh, any_hit, dual=True) != "k2_sdd":
            raise AssertionError("deep tree: the hit queries' options do not select K2")
        outputs[any_hit] = traversal.traverse(bvh, o, d, t_min, t_max, any_hit=any_hit,
                                              **options)
    got = launches.read()
    log(f"deep tree launches {got}")
    if got != dict(Launches.frame_want(0, 0, 0, 0), k2_sdd=2):
        raise AssertionError(f"deep tree: launches {got}, expected 2 of K2 sdd")
    err = 0.0
    for any_hit, out in outputs.items():
        want = traversal.traverse_plain(bvh.node_packed, bvh.leaf_packed, o, d, t_min, t_max,
                                        any_hit)
        torch.cuda.synchronize()
        err = max(err, compare_hits(f"deep tree any_hit={any_hit}", out, want, any_hit)[0])
        run = lambda: traversal.traverse(bvh, o, d, t_min, t_max, any_hit=any_hit,
                                         dual=True, drain_first=any_hit)
        ms = cuda_ms(run, 3)
        log(f"kernel K2 sdd deep tree any_hit={any_hit}: hits={int((want[1] >= 0).sum())} "
            f"max_abs_err_t={err:.3e} k2_ms={ms:.4f}")
    return {"max_abs_err": err, "launches": got["k2_sdd"]}


# -- compaction and the seed test ------------------------------------------------


def compaction_phase(label, bvh, fronts, traversal, compaction, launches) -> dict:
    """K1 within compaction windows on each front, at the PT frame's two
    requests (COMPACT_CLOSEST and COMPACT_ANY ray blocks, snapped to the
    front) in "live" and "morton" order: hits bit-equal to K1's on the
    unpermuted front; the device time of K1 on the permuted front beside K1
    alone, of the permutation alone (around a walk that does nothing), and
    the times of the permutation and of the whole call by CUDA events
    around back-to-back calls (a few dozen small launches each, so the
    host's enqueueing shows); each front's live-lane share. On the any-hit front also
    K3-multi (m = 4) within the windows, the JAX front bench's `compact`
    composition. Returns the launches of the checked calls."""
    counted = collections.Counter()
    for fname, (fo, fd, fmin, fmax, any_hit) in fronts.items():
        n = fo.shape[0]
        k1 = functools.partial(traversal.traverse, bvh, fo, fd, fmin, fmax, any_hit=any_hit)
        want = k1()
        runs = [(f"{order} window {compaction.window_blocks_for(n, request)}",
                 dict(window_blocks=request, order=order), "k1_any_hit" if any_hit else "k1_closest")
                for request in (COMPACT_CLOSEST, COMPACT_ANY) for order in ("live", "morton")]
        if any_hit:
            runs.append((f"morton window {compaction.window_blocks_for(n, COMPACT_ANY)} + "
                         f"K3-multi m=4", dict(window_blocks=COMPACT_ANY, order="morton",
                                               row_cursors=0, multi=4), "k3_wide_multi"))
        nothing = (torch.zeros(n, device=fo.device), torch.full((n,), -1, dtype=torch.int32,
                                                                device=fo.device),
                   torch.zeros(n, device=fo.device), torch.zeros(n, device=fo.device))
        parts = [f"live lanes {float((fd * fd).sum(dim=1).gt(0).float().mean()):.4f}",
                 f"K1 alone {device_ms(k1, TIMING_REPS):.4f}"]
        for tag, kw, key in runs:
            call = functools.partial(compaction.traverse_compacted, bvh, fo, fd, fmin, fmax,
                                     any_hit=any_hit, **kw)
            got, moved = moved_by(launches, call)
            if moved != {key: 1}:
                raise AssertionError(f"{label} {fname} compaction {tag}: launches moved {moved}")
            counted[key] += moved[key]
            torch.cuda.synchronize()
            same = torch.equal(got[1], want[1]) and (any_hit or torch.equal(
                got[0].view(torch.int32), want[0].view(torch.int32)))
            if not same:
                raise AssertionError(f"{label} {fname} compaction {tag}: hits differ from K1's")
            permuted = []

            def capture(bvh_, o, d, t0, t1, **k):
                permuted.append((o, d, t0, t1))
                return nothing

            compaction.traverse_compacted(bvh, fo, fd, fmin, fmax, any_hit=any_hit, **kw,
                                          trav=lambda *a, **k: nothing)
            compaction.traverse_compacted(bvh, fo, fd, fmin, fmax, any_hit=any_hit, **kw,
                                          trav=capture)
            options = {k: v for k, v in kw.items() if k not in ("window_blocks", "order")}
            walk = functools.partial(traversal.traverse, bvh, *permuted[0], any_hit=any_hit,
                                     **options)
            permute = functools.partial(
                compaction.traverse_compacted, bvh, fo, fd, fmin, fmax, any_hit=any_hit, **kw,
                trav=lambda *a, **k: nothing)
            parts.append(f"{tag}: walk of the permuted front {device_ms(walk, TIMING_REPS):.4f} "
                         f"(device), permutation alone {device_ms(permute, TIMING_REPS):.4f} "
                         f"(device) {cuda_ms(permute, TIMING_REPS):.4f} (events), whole call "
                         f"{cuda_ms(call, TIMING_REPS):.4f} (events)")
        log(f"{label} front={fname} compaction (ms; hits bit-equal to K1's): "
            + "; ".join(parts))
    return counted


def seed_tests(tris, fo, fd, fmin, fmax) -> dict:
    """The work the seed test needs on these rays: a ray with a zero
    direction takes no test (none can pass its determinant); any other ray
    tests the triangles of the table `tris` in order up to its first
    occluder, or all; a test stops at the first condition that fails (the
    seed kernel's early exits). Returns the tests and the stage each ended
    at, and the operations with the early exits (`ops`) and with every value
    of a test computed (`full_ops`, the count before the kernel had them)."""
    dev = fd.device
    open_ = (fd != 0).any(dim=1)
    n = {"tests": 0, "det": 0, "u": 0, "v": 0}
    for j in range(tris.shape[1]):
        a, b, c = (tris[k:k + 3, j].to(dev) for k in (0, 3, 6))
        px = fd[:, 1] * c[2] - fd[:, 2] * c[1]
        py = fd[:, 2] * c[0] - fd[:, 0] * c[2]
        pz = fd[:, 0] * c[1] - fd[:, 1] * c[0]
        det = b[0] * px + b[1] * py + b[2] * pz
        passed = det.abs() > 1e-12
        inv = torch.where(passed, 1.0 / det, 0.0)
        tv = fo - a
        u = (tv[:, 0] * px + tv[:, 1] * py + tv[:, 2] * pz) * inv
        q = torch.stack([tv[:, 1] * b[2] - tv[:, 2] * b[1], tv[:, 2] * b[0] - tv[:, 0] * b[2],
                         tv[:, 0] * b[1] - tv[:, 1] * b[0]], 1)
        v = (fd[:, 0] * q[:, 0] + fd[:, 1] * q[:, 1] + fd[:, 2] * q[:, 2]) * inv
        t = (c[0] * q[:, 0] + c[1] * q[:, 1] + c[2] * q[:, 2]) * inv
        u_ok = passed & (u >= 0.0) & (u <= 1.0)
        v_ok = u_ok & (v >= 0.0) & (u + v <= 1.0)
        n["tests"] += int(open_.sum())
        n["det"] += int((open_ & ~passed).sum())
        n["u"] += int((open_ & passed & ~u_ok).sum())
        n["v"] += int((open_ & u_ok & ~v_ok).sum())
        open_ &= ~(v_ok & (t > fmin) & (t < fmax))
    whole = n["tests"] - n["det"] - n["u"] - n["v"]
    return dict(n, ops=n["det"] * SEED_DET_OPS + n["u"] * SEED_U_OPS + n["v"] * SEED_V_OPS
                + whole * SEED_T_OPS,
                full_ops=n["det"] * SEED_DET_OPS + (n["tests"] - n["det"]) * TRI_TEST_OPS)


def seed_phase(label, bvh, fronts, traversal, bvh_ops, launches) -> dict:
    """The seed test (SEED_ROWS rows) on the any-hit front: the kernel
    against its plain version (verdicts and walk directions equal, bit for
    bit), seed-then-walk against the walk (flags equal, every verdict a true
    occlusion), the share of rays it kills, device times of the kernel and
    of K1 on the seeded front beside K1 alone, the times of the seed test
    and K1 in a row and of K1 alone by CUDA events (host enqueueing
    included), and the kernel's bound."""
    fo, fd, fmin, fmax, _ = fronts["nee_any_hit"]
    seed = bvh_ops.make_seed_test(bvh, SEED_ROWS)
    tris = bvh_ops.seed_table(bvh, SEED_ROWS)
    (occ, walk_d), moved = moved_by(launches, lambda: seed(fo, fd, fmin, fmax))
    if moved != {"seed": 1}:
        raise AssertionError(f"{label} seed: launches moved {moved}")
    plain = lambda: bvh_ops.seed_occlusion_plain(tris, fo, fd, fmin, fmax)
    want, want_d = plain()
    differ = int((occ != want).sum()) + int(
        (walk_d.view(torch.int32) != want_d.view(torch.int32)).any(dim=1).sum())
    if differ:
        raise AssertionError(f"{label} seed: {differ} of the kernel's verdicts or directions "
                             f"differ from its plain version")
    k1 = functools.partial(traversal.traverse, bvh, fo, fd, fmin, fmax, any_hit=True)
    k1_seeded = functools.partial(traversal.traverse, bvh, fo, walk_d, fmin, fmax,
                                  any_hit=True)
    occluded = k1()[1] >= 0
    if not torch.equal(occluded, (k1_seeded()[1] >= 0) | occ):
        raise AssertionError(f"{label} seed: seeded any-hit flags differ from the walk's")
    if bool((occ & ~occluded).any()):
        raise AssertionError(f"{label} seed: a seeded ray is not occluded")

    def both():
        _, d = seed(fo, fd, fmin, fmax)
        return traversal.traverse(bvh, fo, d, fmin, fmax, any_hit=True)

    ms = device_ms(lambda: bvh_ops.seed_occlusion_cuda(tris, fo, fd, fmin, fmax), TIMING_REPS)
    plain_ms = cuda_ms(plain, 1)
    n, live = fo.shape[0], int((fd * fd).sum(dim=1).gt(0).sum())
    need = seed_tests(tris, fo, fd, fmin, fmax)
    ops_ms = need["ops"] / F32_OPS * 1e3
    # rays and limits read, verdicts and walk directions written
    bytes_ms = (n * (6 + 2) * 4 + n * (1 + 3 * 4)) / HBM_BYTES_S * 1e3
    k1_events, both_events = cuda_ms(k1, TIMING_REPS), cuda_ms(both, TIMING_REPS)
    log(f"{label} seed test ({SEED_ROWS} rows, {tris.shape[1]} triangles) on the NEE front: "
        f"{n} rays, {live} live, {int(occluded.sum())} occluded, seeded {int(occ.sum())} "
        f"({int(occ.sum()) / max(live, 1):.4f} of live, {int(occ.sum()) / max(int(occluded.sum()), 1):.4f} "
        f"of occluded); device ms: seed kernel {ms:.4f}, K1 alone {device_ms(k1, TIMING_REPS):.4f}, "
        f"K1 on the seeded front {device_ms(k1_seeded, TIMING_REPS):.4f}; events: seed test + K1 "
        f"{both_events:.4f}, K1 alone {k1_events:.4f} (ratio {both_events / k1_events:.3f}); "
        f"plain version {plain_ms:.3f} ms; verdicts or directions differing from it {differ}; "
        f"{need['tests']} triangle tests needed, ended at the determinant {need['det']}, at u "
        f"{need['u']}, at v {need['v']}; bound {max(ops_ms, bytes_ms):.4f} ms "
        f"({ms / max(ops_ms, bytes_ms):.2f}x; with every value of a test computed "
        f"{need['full_ops'] / F32_OPS * 1e3:.4f} ms)")
    return {"max_abs_err": float(differ), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "launches": moved["seed"]}


def sky_phase(atmosphere) -> dict:
    """The sky kernel on the 1920x1080 camera rays of the raster cells' view,
    one origin for every ray (the atmosphere pass's call): against the plain
    loop on the same CUDA rays with the sky on and off (every channel within
    2e-6 + 1e-5 |plain|, NaN where the plain loop is NaN), one launch and
    every ray counted a call, the kernel's device time against its bound
    (SKY_OPS_PER_RAY operations at F32_OPS against its bytes), and the plain
    loop's ms by events (its ~5,000 launches a call outrun any spin)."""
    from rust_renderer_tpu_torch.camera import Camera
    from rust_renderer_tpu_torch.renderers.passes import _camera_rays
    from rust_renderer_tpu_torch.settings import RenderSettings

    cam = Camera(SKY_VIEWPOINT, SKY_TARGET, aspect_ratio=WIDTH / HEIGHT)
    view = RenderSettings.default().with_camera(cam, WIDTH, HEIGHT).to("cuda")
    o, d = _camera_rays(view, WIDTH, HEIGHT)
    sun = view.sun_dir / torch.linalg.vector_norm(view.sun_dir)
    n = WIDTH * HEIGHT

    def plain(flag):
        color, _ = atmosphere.integrate_scattering_plain(o, d, 999999999.0, sun, 1.0)
        return torch.where(flag == 1, torch.clamp_max(color, 1.0), 0.0)

    err, equal = 0.0, []
    for enabled in (1, 0):
        flag = torch.tensor(enabled, dtype=torch.int32, device="cuda")
        before = atmosphere.SKY_LAUNCHES.copy()
        got = atmosphere.sky_radiance(o, d, sun, flag)
        moved = dict(atmosphere.SKY_LAUNCHES - before)
        if moved != {"launches": 1, "rays": n}:
            raise AssertionError(f"sky: a call moved the counter by {moved}")
        want = plain(flag)
        if not torch.equal(torch.isnan(got), torch.isnan(want)):
            raise AssertionError("sky: the kernel's NaNs are not the plain loop's")
        ok = ~torch.isnan(want)
        diff = (got - want).abs()[ok]
        excess = float((diff - (2e-6 + 1e-5 * want.abs()[ok])).max())
        if excess > 0.0:
            raise AssertionError(f"sky: the kernel is off the plain loop by {excess:.3e} "
                                 "beyond 2e-6 + 1e-5 |plain|")
        err = max(err, float(diff.max()))
        equal.append(float((got == want)[ok].float().mean()))
    flag = torch.tensor(1, dtype=torch.int32, device="cuda")
    kernel = lambda: atmosphere.sky_radiance(o, d, sun, flag)
    ms = min(device_ms(kernel, TIMING_REPS) for _ in range(TIMING_ROUNDS))
    events_ms = cuda_ms(kernel, TIMING_REPS)
    plain_ms = cuda_ms(lambda: plain(flag), 1)
    ops_ms = n * SKY_OPS_PER_RAY / F32_OPS * 1e3
    bytes_ms = n * SKY_BYTES_PER_RAY / HBM_BYTES_S * 1e3
    bound = max(ops_ms, bytes_ms)
    log(f"sky kernel on the {WIDTH}x{HEIGHT} front of the raster cells' view: {n} rays; "
        f"largest |kernel - plain| {err:.3e}, bit-equal share {equal[0]:.6f} (sky on) / "
        f"{equal[1]:.6f} (off); device ms {ms:.4f} (best of {TIMING_ROUNDS} rounds of "
        f"{TIMING_REPS}), events {events_ms:.4f}; bound {bound:.4f} ms "
        f"({SKY_OPS_PER_RAY} operations a ray: {ops_ms:.4f} ms; bytes {bytes_ms:.4f} ms; "
        f"{ms / bound:.2f}x); plain loop {plain_ms:.2f} ms by events")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes", "launches": 2}


def ptxas_usage(log_path: str, kernel: str) -> dict:
    """A kernel's registers and spill bytes from its library's `-Xptxas=-v`
    build log (the lines after its "Function properties for" line)."""
    with open(log_path) as f:
        text = f.read()
    found = re.search(r"Function properties for \S*" + kernel + r"\S*\s+"
                      r"\d+ bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads\s+ptxas info\s*: Used (\d+) registers", text)
    if found is None:
        log(f"no ptxas usage of {kernel} in {log_path} (its build log is above)")
        return {"registers": None, "spill_stores": None, "spill_loads": None}
    stores, loads, regs = (int(g) for g in found.groups())
    return {"registers": regs, "spill_stores": stores, "spill_loads": loads}


def plant_cascades(position: torch.Tensor, camera, splits: torch.Tensor) -> None:
    """Overwrite `position`'s (rows, W, 4) rows with points ahead of the
    camera at view depths from 0.5 to 1.25x the last cascade's near split
    across the columns (so in every cascade's range), spread sideways over
    the rows (tests/test_torch_deferred_kernel.py plants the same)."""
    rows, width = position.shape[:2]
    view = torch.tensor(np.asarray(camera.get_view(), np.float32))
    eye = torch.tensor(np.asarray(camera.get_position(), np.float32))
    depth = torch.linspace(0.5, 1.25 * float(splits[-2]), width)
    side = torch.linspace(-2.0, 2.0, rows)
    points = (eye + depth[None, :, None] * -view[2, :3] + side[:, None, None] * view[0, :3]
              + 0.25 * side.flip(0)[:, None, None] * view[1, :3])
    position[..., :3] = points.to(position.device)
    position[..., 3] = 1.0


def deferred_phase(native) -> dict:
    """The deferred kernel on the inputs of the Sponza-scale scene's 1920x1080
    deferred pass (a RASTERIZED frame with the shadows on, so the four 4096^2
    cascades are real; the view's own pixels lie in cascades 0 and 1 only,
    so rows DEFERRED_PLANTED_ROWS are planted with positions in every
    cascade's range, and the plain body must reach each): against the plain
    body on the same CUDA inputs under every combination of
    DEFERRED_TOGGLES, with 0, 3 and 10 lights (every channel within
    DEFERRED_RTOL x max(1, |plain|), no NaN; one launch and every pixel
    counted a call); its device time in the two benchmark cells' settings
    against its byte bound (DEFERRED_BYTES_PER_PIXEL at 3.35 TB/s) and the
    plain body's ms by events; its registers and spills; its launches in
    host frames, and its kernel records in captured replays (torch.profiler).
    Returns the kernels line's fields and the phase's launches."""
    from torch.profiler import ProfilerActivity, profile

    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.ops import deferred, shadow
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    start = deferred.DEFERRED_LAUNCHES["launches"]
    app = Application(WIDTH, HEIGHT, RenderGraphMode.RASTERIZED, device="cuda")
    app.create_scene(create_sponza_scale_scene)
    seen = []
    composite = deferred.deferred_composite

    def record(*args):
        seen.append(args)
        return composite(*args)

    deferred.deferred_composite = record
    try:
        app.run(1)
    finally:
        deferred.deferred_composite = composite
    scene, _, *inputs = seen[0]
    p = dict(zip(("position", "normal", "albedo", "pbr", "rt_reflections", "rt_shadows",
                  "ssao", "shadow_map", "cascade_vp", "cascade_splits", "irradiance_map",
                  "specular_map", "brdf_lut"), inputs))
    p["position"] = p["position"].clone()
    plant_cascades(p["position"][DEFERRED_PLANTED_ROWS], app.camera, p["cascade_splits"].cpu())
    planes = list(p.values())
    n = WIDTH * HEIGHT

    def view_of(num_lights, **toggles):
        view = app.view.with_camera(app.camera, WIDTH, HEIGHT).replace(
            num_lights=np.int32(num_lights), **{k: np.int32(v) for k, v in toggles.items()})
        return view.to("cuda")

    _, cascade = shadow.calculate_shadow(p["position"][..., :3], view_of(0).view,
                                         p["shadow_map"], p["cascade_vp"], p["cascade_splits"])
    reached = sorted(cascade.unique().tolist())
    if reached != list(range(p["shadow_map"].shape[0])):
        raise AssertionError(f"deferred: the plain body reaches cascades {reached} only")
    gap, worst = 0.0, -1.0
    for combo in itertools.product((0, 1), repeat=len(DEFERRED_TOGGLES)):
        for num_lights in (0, 3, 10):
            view = view_of(num_lights, **dict(zip(DEFERRED_TOGGLES, combo)))
            before = deferred.DEFERRED_LAUNCHES.copy()
            got = deferred.deferred_composite(scene, view, *planes)
            moved = dict(deferred.DEFERRED_LAUNCHES - before)
            if moved != {"launches": 1, "pixels": n}:
                raise AssertionError(f"deferred: a call moved the counter by {moved}")
            want = deferred.deferred_composite_plain(scene, view, *planes)
            if bool(torch.isnan(got).any()) or bool(torch.isnan(want).any()):
                raise AssertionError(f"deferred: NaN under {combo}, {num_lights} lights")
            diff = (got - want).abs()
            excess = float((diff - DEFERRED_RTOL * torch.clamp_min(want.abs(), 1.0)).max())
            if excess > 0.0:
                raise AssertionError(f"deferred: the kernel is off the plain body by "
                                     f"{excess:.3e} beyond its tolerance under {combo}, "
                                     f"{num_lights} lights")
            gap, worst = max(gap, float(diff.max())), max(worst, excess)
    times = {}
    for cell, shadows in (("rtshadows", 0), ("cascaded", 1)):
        view = view_of(10, shadows_enabled=shadows)
        kernel = lambda: deferred.deferred_composite(scene, view, *planes)
        times[cell] = min(device_ms(kernel, TIMING_REPS) for _ in range(TIMING_ROUNDS))
        times[f"{cell}_plain"] = cuda_ms(
            lambda: deferred.deferred_composite_plain(scene, view, *planes), 1)
    bound = n * DEFERRED_BYTES_PER_PIXEL / HBM_BYTES_S * 1e3
    usage = ptxas_usage(f"{native.BUILD_DIR}/libdeferred_shade.so.log",
                        "deferred_shade_kernel")

    before = deferred.DEFERRED_LAUNCHES["launches"]
    app.run(2)
    host = deferred.DEFERRED_LAUNCHES["launches"] - before
    app.run_on_device(FRAMES)  # the eager frame, the capture, FRAMES - 1 replays
    captured = deferred.DEFERRED_LAUNCHES["launches"] - before - host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        app.run_on_device(FRAMES)  # FRAMES replays
        torch.cuda.synchronize()
    replayed = sum(e.count for e in prof.key_averages() if "deferred_shade_kernel" in e.key)
    if host != 2 or captured != 2 or replayed != FRAMES:
        raise AssertionError(f"deferred: {host} launches in 2 host frames, {captured} in "
                             f"a captured call, {replayed} kernel records in {FRAMES} "
                             "replays")
    log(f"deferred kernel on the Sponza-scale {WIDTH}x{HEIGHT} deferred pass (cascades "
        f"{reached} reached), 96 settings (every toggle, 0 / 3 / 10 lights): largest "
        f"|kernel - plain| {gap:.3e} (worst excess over {DEFERRED_RTOL} x max(1, |plain|): "
        f"{worst:.3e}); device ms {times['rtshadows']:.4f} (RT shadows) / "
        f"{times['cascaded']:.4f} (cascades) (best of {TIMING_ROUNDS} rounds of "
        f"{TIMING_REPS}); byte bound {bound:.4f} ms ({DEFERRED_BYTES_PER_PIXEL} B a pixel; "
        f"{times['rtshadows'] / bound:.2f}x / {times['cascaded'] / bound:.2f}x); plain body "
        f"{times['rtshadows_plain']:.2f} / {times['cascaded_plain']:.2f} ms by events; "
        f"{usage['registers']} registers, spill stores {usage['spill_stores']} B, loads "
        f"{usage['spill_loads']} B; launches: {host} in 2 host frames, {captured} in "
        f"run_on_device({FRAMES}) (eager frame + capture), {replayed} kernel records in "
        f"{FRAMES} replays")
    return {"launches": deferred.DEFERRED_LAUNCHES["launches"] - start, "max_abs_err": gap,
            "ms": times["cascaded"], "plain_ms": times["cascaded_plain"], "bound_ms": bound,
            "bound_by": "bytes", **usage}


def deferred_alone() -> int:
    """`--deferred`: the kernels built, then the deferred phase; no kernels
    line, and the last line {"ok": true, "card": ...}."""
    from rust_renderer_tpu_torch import native

    card = build_kernels()
    deferred_phase(native)
    log(f"chip_smoke --deferred total {time.perf_counter() - START:.1f} s")
    print(json.dumps({"ok": True, "card": card}))
    return 0


def ssao_phase(native) -> dict:
    """The SSAO kernels on the inputs of the Sponza-scale scene's 1920x1080
    SSAO pass (a RASTERIZED frame): against the plain body on the same CUDA
    inputs with the pass's select off (`enabled` None), 0 and 1, bit for bit
    (or the share of pixels off, printed, then raised); two launches and
    every pixel counted a call; the call's device time (the depth kernel,
    the occlusion kernel and the normal matrix's inverse) against its bound
    (SSAO_OPS_PER_PIXEL at F32_OPS, SSAO_BYTES_PER_PIXEL at 3.35 TB/s), each
    kernel's own device ms (torch.profiler), the plain body's ms by events;
    the kernels' registers and spills; their launches in host frames, and
    their kernel records in captured replays. Returns the kernels line's
    fields and the phase's launches."""
    from torch.profiler import ProfilerActivity, profile

    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.ops import ssao
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    start = ssao.SSAO_LAUNCHES["launches"]
    app = Application(WIDTH, HEIGHT, RenderGraphMode.RASTERIZED, device="cuda")
    app.create_scene(create_sponza_scale_scene)
    seen = []
    stencil = ssao.ssao_stencil

    def record(*args, **kw):
        seen.append((args, kw))
        return stencil(*args, **kw)

    ssao.ssao_stencil = record
    try:
        app.run(1)
    finally:
        ssao.ssao_stencil = stencil
    (args, kw), = seen
    args = [a.clone() for a in args]
    n = WIDTH * HEIGHT
    off = {}
    for enabled in (None, 0, 1):
        select = {} if enabled is None else {
            "enabled": torch.full_like(kw["enabled"], enabled)}
        before = ssao.SSAO_LAUNCHES.copy()
        got = ssao.ssao_stencil(*args, **select)
        moved = dict(ssao.SSAO_LAUNCHES - before)
        if moved != {"launches": RASTER_SSAO, "pixels": n}:
            raise AssertionError(f"ssao: a call moved the counter by {moved}")
        want = ssao.ssao_stencil_plain(*args, **select)
        differ = got != want
        off[enabled] = (int(differ.sum()), float((got - want).abs().max()))
        if enabled != 0 and not float(got.min()) < 0.5:
            raise AssertionError(f"ssao: no occlusion on the frame ({float(got.min())})")
    select = {"enabled": kw["enabled"]}
    kernel = lambda: ssao.ssao_stencil(*args, **select)
    ms = min(device_ms(kernel, TIMING_REPS) for _ in range(TIMING_ROUNDS))
    plain_ms = cuda_ms(lambda: ssao.ssao_stencil_plain(*args, **select), 1)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(TIMING_REPS):
            kernel()
        torch.cuda.synchronize()
    device_us = lambda e: e.device_time_total
    own = {name: sum(device_us(e) for e in prof.key_averages() if name in e.key)
           / TIMING_REPS / 1e3 for name in ("ssao_depth_kernel", "ssao_occlusion_kernel")}
    call_ms = sum(device_us(e) for e in prof.key_averages()
                  if e.count >= TIMING_REPS) / TIMING_REPS / 1e3
    ops_bound = n * SSAO_OPS_PER_PIXEL / F32_OPS * 1e3
    bytes_bound = n * SSAO_BYTES_PER_PIXEL / HBM_BYTES_S * 1e3
    bound = max(ops_bound, bytes_bound)
    usage = {name: ptxas_usage(f"{native.BUILD_DIR}/libssao.so.log", name)
             for name in ("ssao_depth_kernel", "ssao_occlusion_kernel")}

    before = ssao.SSAO_LAUNCHES["launches"]
    app.run(2)
    host = ssao.SSAO_LAUNCHES["launches"] - before
    app.run_on_device(FRAMES)  # the eager frame, the capture, FRAMES - 1 replays
    captured = ssao.SSAO_LAUNCHES["launches"] - before - host
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        app.run_on_device(FRAMES)  # FRAMES replays
        torch.cuda.synchronize()
    replayed = sum(e.count for e in prof.key_averages() if "ssao_" in e.key
                   and "_kernel" in e.key)
    if host != 2 * RASTER_SSAO or captured != 2 * RASTER_SSAO or \
            replayed != FRAMES * RASTER_SSAO:
        raise AssertionError(f"ssao: {host} launches in 2 host frames, {captured} in a "
                             f"captured call, {replayed} kernel records in {FRAMES} replays")
    log(f"ssao kernels on the Sponza-scale {WIDTH}x{HEIGHT} SSAO pass: pixels off the plain "
        f"body (count, largest gap) by select None / 0 / 1: {off[None]} / {off[0]} / "
        f"{off[1]}; call device ms {ms:.4f} (best of {TIMING_ROUNDS} rounds of "
        f"{TIMING_REPS}; profiled {call_ms:.4f}: depth kernel "
        f"{own['ssao_depth_kernel']:.4f}, occlusion kernel {own['ssao_occlusion_kernel']:.4f}, "
        f"the rest the normal matrix's inverse); bound {bound:.4f} ms (operations "
        f"{ops_bound:.4f}: {SSAO_OPS_PER_PIXEL} a pixel; bytes {bytes_bound:.4f}: "
        f"{SSAO_BYTES_PER_PIXEL} B a pixel; {ms / bound:.2f}x); plain body {plain_ms:.2f} ms by "
        f"events; registers, spill stores / loads: " + ", ".join(
            f"{name} {u['registers']} / {u['spill_stores']} B / {u['spill_loads']} B"
            for name, u in usage.items())
        + f"; launches: {host} in 2 host frames, {captured} in run_on_device({FRAMES}) (eager "
        f"frame + capture), {replayed} kernel records in {FRAMES} replays")
    if any(count for count, _ in off.values()):
        raise AssertionError(f"ssao: the kernels are not bit-equal to the plain body: {off}")
    occlusion = usage["ssao_occlusion_kernel"]
    return {"launches": ssao.SSAO_LAUNCHES["launches"] - start, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_bound >= bytes_bound else "bytes",
            "depth_ms": own["ssao_depth_kernel"],
            "occlusion_ms": own["ssao_occlusion_kernel"], **occlusion}


def ssao_alone() -> int:
    """`--ssao`: the kernels built, then the SSAO phase; no kernels line, and
    the last line {"ok": true, "card": ...}."""
    from rust_renderer_tpu_torch import native

    card = build_kernels()
    ssao_phase(native)
    log(f"chip_smoke --ssao total {time.perf_counter() - START:.1f} s")
    print(json.dumps({"ok": True, "card": card}))
    return 0


def sky_alone() -> int:
    """`--sky`: the kernels built, the sky phase, then a RASTERIZED app of
    the default scene at 1920x1080 (marching cubes off): FRAMES host frames
    (`run_frames`: the sky kernel launched twice a frame, over every pixel)
    and the per-pass ms of one more frame; no kernels line, and the last
    line {"ok": true, "card": ...}."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.ops import atmosphere, bvh as bvh_ops, raster_binned, traversal
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    card = build_kernels()
    sky_phase(atmosphere)
    app = Application(WIDTH, HEIGHT, RenderGraphMode.RASTERIZED, device="cuda")
    app.create_scene()
    run_frames("RASTERIZED", app, Launches(traversal, raster_binned, bvh_ops),
               Launches.frame_want(2, 1, 4, 0, **RASTER_FRAME))
    pass_times("RASTERIZED", app)
    log(f"chip_smoke --sky total {time.perf_counter() - START:.1f} s")
    print(json.dumps({"ok": True, "card": card}))
    return 0


# -- rasterizer ----------------------------------------------------------------


def raster_bound(raster_binned, bins, width: int, height: int, pair_ops: int,
                 out_bytes: int) -> dict:
    """The least time of a binned raster: the (row, pixel) tests that the
    data needs — each row on the pixels of its triangle's box widened by one
    pixel, inside its tile for a segment row, as the plain version
    enumerates them and K4 tests them — at `pair_ops` operations each,
    against the bytes of the table's live rows (the segments and the global
    list: the rows a walk reads, not the static table's empty slots), the
    tile lists and the output, each once."""
    x0, x1, y0, y1 = raster_binned.row_boxes(bins)
    pairs = int(((x1 - x0 + 1).clamp_min(0) * (y1 - y0 + 1).clamp_min(0)).sum())
    live = int(bins.counts.sum()) + int(bins.g_count)
    nbytes = (live * bins.table.shape[1] * 4 + bins.starts.numel() * 4
              + bins.counts.numel() * 4 + width * height * out_bytes)
    ops_ms, bytes_ms = pairs * pair_ops / F32_OPS * 1e3, nbytes / HBM_BYTES_S * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "pairs": pairs, "ops_ms": ops_ms,
            "bytes_ms": bytes_ms, "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def k4_plan_stats(raster_binned, bins) -> dict:
    """K4's work plan on `bins` (the plan kernel's, held to its plain
    version): its items, the longest item's rows, and the share of (tile,
    global row) pairs whose box misses the tile (one comparison each in the
    kernel)."""
    plan = raster_binned.depth_plan(bins)
    if not torch.equal(plan.ends, raster_binned.depth_plan_plain(bins).ends):
        raise AssertionError("the plan kernel differs from its plain version")
    _, _, rows = raster_binned.depth_plan_items(bins, plan)
    x0, x1, y0, y1 = (b[bins.g_base:] for b in bins.row_box)
    live = (x1 >= x0) & (y1 >= y0)
    tiles = torch.where(live, (x1 // raster_binned.TILE_W - x0 // raster_binned.TILE_W + 1)
                        * (y1 // raster_binned.TILE_H - y0 // raster_binned.TILE_H + 1), 0)
    pairs = int(bins.g_count) * bins.nx * bins.ny
    return {"items": rows.numel(), "longest_item": int(rows.max()) if rows.numel() else 0,
            "global_culled": 1.0 - int(tiles.sum()) / pairs if pairs else 0.0}


def bins_differ(got, want) -> list[str]:
    """The fields in which two Bins differ (the table compared bit for
    bit); empty where they are equal."""
    off = [name for name in ("g_base", "nx", "ny") if getattr(got, name) != getattr(want, name)]
    if got.table.shape != want.table.shape or not torch.equal(
            got.table.view(torch.int32), want.table.view(torch.int32)):
        off.append("table")
    for name in ("starts", "counts", "g_count", "row_tile"):
        a, b = getattr(got, name), getattr(want, name)
        if a.dtype != b.dtype or not torch.equal(a, b):
            off.append(name)
    off += [f"row_box {i}" for i, (a, b) in enumerate(zip(got.row_box, want.row_box))
            if a.dtype != b.dtype or not torch.equal(a, b)]
    return off


def device_records(fn) -> int:
    """The records on the card of one call of fn: kernels, copies and sets
    (torch.profiler, CUDA only)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.device_type == DeviceType.CUDA for e in prof.events())


def binning_stats(raster_binned, clip, indices, width: int, height: int, vis: bool) -> dict:
    """The binning of one raster call as `rasterize_depth_binned` /
    `rasterize_binned` run it before K4 / K5: on CUDA tensors the binning
    library (`binned_rows`, csrc/raster_bin.cu), held to its plain version
    (`tri_rows`, then `bin_triangles`) bit for bit in every field. For each:
    its ms on the device alone and by events, and its launches a call (the
    library's by its counter, the plain version's as its records on the
    card); the bytes of the tables a call makes (the table, the rows' tiles
    and pixel boxes, the tile lists), with the table's slots beside the
    rows the walks read, and the time those bytes take at HBM_BYTES_S. The
    plain version's call is ~420 launches, so device times are the median
    of TIMING_ROUNDS single calls behind the spin: several calls' launches
    overflow the stream's queue of pending launches, and the host then
    waits for the spin. A port without the library (a parent checkout)
    times the plain version alone. Returns the stats, with the library's
    Bins ("bins", the plain version's where there is none) and the plain
    version's ("plain_bins")."""
    plain = lambda: raster_binned.bin_triangles(
        raster_binned.tri_rows(clip, indices, width, height, vis=vis), width, height)
    calls = {"plain": plain}
    if hasattr(raster_binned, "bins_cuda"):
        calls["library"] = lambda: raster_binned.binned_rows(clip, indices, width, height, vis)
    out = {"plain_bins": plain()}
    launches = {}
    if "library" in calls:
        before = raster_binned.BIN_LAUNCHES
        out["bins"] = calls["library"]()
        launches["library"] = raster_binned.BIN_LAUNCHES - before
    else:
        out["bins"] = out["plain_bins"]
    off = bins_differ(out["bins"], out["plain_bins"])
    if off:
        raise AssertionError(f"the binning library's Bins differ from the plain version's in {off}")
    bins = out["bins"]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (bins.table, bins.row_tile, *bins.row_box, bins.starts, bins.counts))
    out.update(bytes=nbytes, bytes_ms=nbytes / HBM_BYTES_S * 1e3,
               table_bytes=bins.table.numel() * 4, slots=bins.table.shape[0],
               live=int(bins.counts.sum()) + int(bins.g_count))
    launches["plain"] = device_records(plain)
    for name, call in calls.items():
        alone = sorted(device_ms(call, 1) for _ in range(TIMING_ROUNDS))
        out[name] = {"ms": alone[len(alone) // 2], "events_ms": cuda_ms(call, TIMING_REPS),
                     "launches": launches[name]}
    return out


def binning_line(stats: dict) -> str:
    line = ", ".join(
        f"{name} {stats[name]['ms']:.4f} ms on the device alone (events "
        f"{stats[name]['events_ms']:.4f}) in {stats[name]['launches']} launches a call"
        for name in ("library", "plain") if name in stats)
    if "library" in stats:
        line += "; bit-equal Bins"
    return (f"binning: {line}; tables {stats['bytes'] / 1e6:.1f} MB a call "
            f"({stats['bytes_ms']:.4f} ms at {HBM_BYTES_S / 1e12:.2f} TB/s; the table "
            f"{stats['table_bytes'] / 1e6:.1f} MB), "
            f"{stats['slots']} slots of which {stats['live']} live")


def exact_gap(raster_binned, got, clip, indices, size: int) -> dict:
    """K4's depth `got` against the float64 interpolation at K4's own
    coverage (`raster_binned.depth_exact`): whether the coverage is the
    same, the largest gap on a covered texel and the texels beyond 1e-4
    and beyond the shadow bias (5e-4)."""
    exact = raster_binned.depth_exact(clip, indices, size, size)
    covered = exact < 1.0
    gap = (got.double() - exact)[covered].abs()
    return {"same_coverage": bool(torch.equal(got < 1.0, covered)),
            "max_gap": float(gap.max()) if gap.numel() else 0.0,
            "beyond_1e-4": int((gap > 1e-4).sum()), "beyond_5e-4": int((gap > 5e-4).sum())}


def k4_phase(app, raster, raster_binned, shadow, check_exact: bool = True) -> dict:
    """K4 against its plain version on the app's scene's cascades: bit for
    bit, against the float64 interpolation (`exact_gap`; held to
    K4_EXACT_ATOL with `check_exact`), its plan, its time on the device
    alone (its wrapper's clear and plan included) and by events around
    back-to-back calls (the host's enqueueing included), the plain
    version's by events; the binning's device ms and table bytes beside it
    (`binning_stats`: the library's Bins held to the plain version's bit for
    bit, and K4 over them to K4 over the plain version's)."""
    cfg, scene = app.cfg, app.scene
    size = cfg.shadow_map_size
    matrices, _ = shadow.cascade_matrices(
        app.camera.get_view(), app.camera.get_projection(), app.camera.get_near_plane(),
        app.camera.get_far_plane(), app.sun_dir, cfg.shadow_cascade_count)
    k4_ms, plain_ms, bounds, err = [], [], [], 0.0
    for i, m in enumerate(torch.as_tensor(matrices, device=app.device)):
        clip = raster.transform_vertices(scene.positions, m)
        binning = binning_stats(raster_binned, clip, scene.indices, size, size, vis=False)
        bins = binning["bins"]
        k4 = lambda: raster_binned.depth_binned_cuda(bins, size, size)
        plain = lambda: raster_binned.depth_binned_plain(bins, size, size)
        got, want = k4(), plain()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"K4 cascade {i}: depth differs from the plain version on "
                                 f"{int((got != want).sum())} texels")
        if not torch.equal(got, raster_binned.depth_binned_cuda(binning["plain_bins"], size,
                                                                size)):
            raise AssertionError(f"K4 cascade {i}: depth over the library's Bins differs from "
                                 "K4 over the plain version's")
        del binning["plain_bins"]
        err = max(err, float((got - want).abs().max()))
        exact = exact_gap(raster_binned, got, clip, scene.indices, size)
        log(f"K4 cascade {i} against the float64 interpolation: {exact}")
        if check_exact and not (exact["same_coverage"]
                                and exact["max_gap"] <= K4_EXACT_ATOL):
            raise AssertionError(f"K4 cascade {i}: depth departs from the float64 "
                                 f"interpolation: {exact}")
        k4()  # warm-up
        k4_ms.append(device_ms(k4, TIMING_REPS))
        events_ms = cuda_ms(k4, TIMING_REPS)
        plain_ms.append(cuda_ms(plain, 1))
        bounds.append(raster_bound(raster_binned, bins, size, size, K4_PAIR_OPS, 4))
        plan = k4_plan_stats(raster_binned, bins)
        if not k4_ms[-1] < plain_ms[-1]:
            raise AssertionError(f"K4 cascade {i}: {k4_ms[-1]:.4f} ms, not faster than its plain "
                                 f"version ({plain_ms[-1]:.3f} ms)")
        log(f"cascade {i}: " + binning_line(binning))
        log(f"kernel K4 cascade={i} {size}x{size} slots={bins.table.shape[0]} "
            f"global={int(bins.g_count)} longest_segment={int(bins.counts.max())} "
            f"items={plan['items']} longest_item={plan['longest_item']} rows "
            f"box_pairs={bounds[-1]['pairs']} global_culled_by_box={plan['global_culled']:.4f} "
            f"covered={float((got < 1).float().mean()):.4f} bit_equal=True "
            f"k4_ms={k4_ms[-1]:.4f} (device alone; events {events_ms:.4f}) "
            f"plain_ms={plain_ms[-1]:.3f} bound_ms={bounds[-1]['bound_ms']:.4f} "
            f"({bounds[-1]['bound_by']})")
    # ms is the mean cascade's, and so is the bound.
    ops_ms = sum(b["ops_ms"] for b in bounds) / len(bounds)
    bytes_ms = sum(b["bytes_ms"] for b in bounds) / len(bounds)
    return {"max_abs_err": err, "ms": sum(k4_ms) / len(k4_ms),
            "plain_ms": sum(plain_ms) / len(plain_ms), "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def mc_bins(app, raster, raster_binned, marching_cubes):
    """The marching-cubes draw's front at WIDTH x HEIGHT: the surface of
    the app's view, its visibility bins, its slot count, and the (clip,
    indices) it was binned from."""
    dev = app.device
    view = app.view.to(dev)
    result = marching_cubes.marching_cubes(grid=app.cfg.mc_grid,
                                           voxel_size=32.0 / app.cfg.mc_grid, time=view.time)
    t = result.positions.shape[0]
    clip = raster.transform_vertices(result.positions.reshape(-1, 3),
                                     view.projection @ view.view)
    idx = torch.arange(3 * t, dtype=torch.int32, device=dev).reshape(-1, 3)
    if hasattr(raster_binned, "binned_rows"):
        bins = raster_binned.binned_rows(clip, idx, WIDTH, HEIGHT, vis=True)
    else:  # a port before the binning library
        bins = raster_binned.bin_triangles(
            raster_binned.tri_rows(clip, idx, WIDTH, HEIGHT, vis=True), WIDTH, HEIGHT)
    return result, bins, t, (clip, idx)


def k5_times(raster_binned, bins) -> tuple[float, float]:
    """K5's wrapper on `bins` (the plan kernel, K5's launcher and the
    wrapper's allocations): its ms on the device alone, and by events
    around back-to-back calls (the host's enqueueing included)."""
    k5 = lambda: raster_binned.vis_binned_cuda(bins, WIDTH, HEIGHT)
    k5()  # warm-up
    return device_ms(k5, TIMING_REPS), cuda_ms(k5, TIMING_REPS)


def k5_phase(app, raster, raster_binned, marching_cubes, gbuffer_depth) -> dict:
    """K5 against its plain version on the marching-cubes front at 1080p
    (triangle ids bit for bit, depth and barycentrics within VIS_ATOL), raw
    and after the LOAD-op merge over the gbuffer depth; its plan (K4's, over
    the visibility bins), its times (`k5_times`), the plain version's by
    events. Its bound counts the bytes its function needs (the table, the
    tile lists and the 16 B per pixel of the buffer); the key plane's 8 B
    per pixel, written and read, are its design's own traffic, shown
    beside it."""
    result, bins, t, (clip, idx) = mc_bins(app, raster, raster_binned, marching_cubes)
    binning = binning_stats(raster_binned, clip, idx, WIDTH, HEIGHT, vis=True)
    if bins_differ(bins, binning["plain_bins"]):
        raise AssertionError("K5's Bins differ from the plain version's")
    del binning["plain_bins"], binning["bins"]
    log("marching-cubes front: " + binning_line(binning))
    got = raster_binned.vis_binned_cuda(bins, WIDTH, HEIGHT)
    want = raster_binned.vis_binned_plain(bins, WIDTH, HEIGHT)
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
    k5_ms, events_ms = k5_times(raster_binned, bins)
    plain_ms = cuda_ms(lambda: raster_binned.vis_binned_plain(bins, WIDTH, HEIGHT), 2)
    bound = raster_bound(raster_binned, bins, WIDTH, HEIGHT, K5_PAIR_OPS, 16)
    key_ms = WIDTH * HEIGHT * 8 * 2 / HBM_BYTES_S * 1e3
    plan = k4_plan_stats(raster_binned, bins)
    log(f"kernel K5 marching-cubes front {WIDTH}x{HEIGHT} slots={t} "
        f"table_slots={bins.table.shape[0]} valid={int(result.valid.sum())} "
        f"global={int(bins.g_count)} "
        f"longest_segment={int(bins.counts.max())} items={plan['items']} "
        f"longest_item={plan['longest_item']} rows box_pairs={bound['pairs']} "
        f"global_culled_by_box={plan['global_culled']:.4f} "
        f"covered={float((got.tri >= 0).float().mean()):.4f} "
        f"drawn_over_gbuffer={float((merged[0].tri >= 0).float().mean()):.4f} "
        f"max_abs_err={err:.3e} k5_ms={k5_ms:.4f} (device alone; events {events_ms:.4f}) "
        f"plain_ms={plain_ms:.3f} bound_ms={bound['bound_ms']:.4f} ({bound['bound_by']}; "
        f"the key plane's own traffic, written and read once, adds {key_ms:.4f})")
    return {"max_abs_err": err, "ms": k5_ms, "plain_ms": plain_ms,
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"]}


def k4_alone() -> int:
    """`chip_smoke.py --k4`: the kernels built, then `k4_phase` on the four
    4096^2 cascades of the Sponza-scale scene (the benchmark's
    raster_sponza_1080p), TIMING_ROUNDS times; the gaps to the float64
    interpolation logged, not held. It reads K4 through
    `depth_binned_cuda(bins, size, size)` and the binning, so a copy of this
    script beside another checkout's package times that checkout's K4 on
    the same cascades (given `raster_binned.depth_exact` and
    `native.LIBRARIES` where it has none)."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.models import create_sponza_scale_scene
    from rust_renderer_tpu_torch.ops import raster, raster_binned, shadow
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    card = build_kernels()
    app = Application(WIDTH, HEIGHT, RenderGraphMode.RASTERIZED, device="cuda")
    app.create_scene(create_sponza_scale_scene)
    for r in range(TIMING_ROUNDS):
        k4 = k4_phase(app, raster, raster_binned, shadow, check_exact=False)
        log(f"K4 alone round {r}: {k4}")
    log(f"chip_smoke --k4 total {time.perf_counter() - START:.1f} s")
    print(json.dumps({"ok": True, "card": card}))
    return 0


def k5_alone() -> int:
    """`chip_smoke.py --k5`: K5's times (`k5_times`) on the marching-cubes
    front of a fresh RASTERIZED app's camera at view time PARITY_TIME, in
    TIMING_ROUNDS rounds, and nothing else. It reads K5 through `vis_binned_cuda(bins, width, height)` and
    the binning, so a copy of this script beside another checkout's package
    times that checkout's K5 on the same front."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.ops import marching_cubes, raster, raster_binned
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    print(card_line(), flush=True)
    app = Application(WIDTH, HEIGHT, RenderGraphMode.RASTERIZED, device="cuda")
    app.view = app.view.with_camera(app.camera, WIDTH, HEIGHT).replace(
        time=np.float32(PARITY_TIME), marching_cubes_enabled=np.int32(1))
    _, bins, t, _ = mc_bins(app, raster, raster_binned, marching_cubes)
    for r in range(TIMING_ROUNDS):
        k5_ms, events_ms = k5_times(raster_binned, bins)
        log(f"K5 alone round {r}: marching-cubes front {WIDTH}x{HEIGHT}, {t} slots, "
            f"{bins.table.shape[0]} rows: {k5_ms:.4f} ms on the device alone, "
            f"{events_ms:.4f} by events")
    return 0


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


def furnace_phase(Application, StaticConfig, launches) -> dict:
    """The furnace test (StaticConfig(furnace_test=True), the
    energy-conservation diagnostic): one PT frame of the RTIOW scene's four
    spheres (`models.create_rtiow_scene`) with the
    sky, sun and lights off, on the card and on the CPU. Every miss sees a
    white sky, so the top row (the sky) is 1.0 on both; the frames agree
    under the PT parity tolerance; the card's frame launches K1 (on the
    empty triangle tree) only."""
    from rust_renderer_tpu_torch.models import create_rtiow_scene

    size, bounces = FURNACE_SIZE, 2
    frames = {}
    for device in ("cpu", "cuda"):
        app = Application(size, size, cfg=StaticConfig(num_bounces=bounces, furnace_test=True),
                          device=device)
        app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
        app.view = app.view.replace(sky_enabled=np.int32(0), sun_shadow_enabled=np.int32(0),
                                    lights_enabled=np.int32(0))
        app.create_scene(create_rtiow_scene)
        launches.reset()
        frames[device] = app.render_frame()["present_output"].cpu()
        got = launches.read()
    # No lights: the graph is the path tracer and present, without the
    # gbuffer's primary front; the tree holds no triangle, so no seed test.
    want = Launches.frame_want(bounces, bounces, 0, 0)
    if got != want:
        raise AssertionError(f"furnace: launches {got}, expected {want}")
    a, b = frames["cpu"], frames["cuda"]
    diff = (a - b).abs()
    within = float((diff.amax(dim=-1) <= 1e-3).float().mean())
    top = max(float((a[0] - 1.0).abs().max()), float((b[0] - 1.0).abs().max()))
    log(f"furnace {size}x{size}: top row |x - 1| max {top:.3e}, card vs CPU within_1e-3="
        f"{within:.5f} mean_abs={float(diff.mean()):.3e} max_abs={float(diff.max()):.3e}, "
        f"launches {got}")
    if top > 1e-5 or within < 0.99 or float(diff.mean()) > 1e-3 \
            or not bool(torch.isfinite(b).all()):
        raise AssertionError("furnace: the card's frame fails the furnace test")
    return got


# -- config 5: the traced marching-cubes isosurface; the raster visibility -------


def mc_frames_in_turns(app, launches, counted, want_on: dict, want_off: dict) -> None:
    """Config 5's frame with the isosurface on and off (the graph rebuilt
    without the MC passes), MC_TURNS of each in turns: launch counts per
    frame, the medians and their difference."""
    times = {"on": [], "off": []}
    for i in range(2 * MC_TURNS):
        key = ("on", "off")[i % 2]
        app.view = app.view.replace(marching_cubes_enabled=np.int32(key == "on"))
        launches.reset()
        _, t = timed(app.render_frame)
        times[key].append(t)
        got = launches.read()
        want = want_on if key == "on" else want_off
        if got != want:
            raise AssertionError(f"config 5 (MC {key}): launches {got}, expected {want}")
        counted.update(got)
    app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
    med = {k: sorted(v)[len(v) // 2] for k, v in times.items()}
    log(f"config 5 frames in turns, MC on / off: {[round(x, 2) for x in times['on']]} / "
        f"{[round(x, 2) for x in times['off']]} ms; medians {med['on']:.2f} / {med['off']:.2f} "
        f"ms: the isosurface costs {med['on'] - med['off']:.2f} ms a frame "
        f"(ratio {med['on'] / med['off']:.3f})")


def dyn_k1_phase(app, dyn, traversal, rays, pathtrace) -> dict:
    """K1 on the dynamic tree against the plain walk on the same refit
    tables, on config 5's 1080p primary, bounce and NEE fronts: hits, K1's
    time (events, and on the device alone) beside K1 on the scene's tree
    on the same front, its own walk's counts and bound (its stats form)."""
    fronts = make_fronts(app, traversal, rays, pathtrace, dyn=dyn)
    bvh = dyn.bvh
    out = {"max_abs_err": 0.0}
    for name, front in fronts.items():
        fo, fd, fmin, fmax, any_hit = front
        k1 = lambda: traversal.traverse_wide_cuda(bvh.wnode_packed, bvh.leaf_packed,
                                                  bvh.wide_depth, fo, fd, fmin, fmax, any_hit)
        static = app.scene_bvh
        k1_static = lambda: traversal.traverse_wide_cuda(
            static.wnode_packed, static.leaf_packed, static.wide_depth, fo, fd, fmin, fmax,
            any_hit)
        want, plain_ms = timed(lambda: traversal.traverse_plain(
            bvh.node_packed, bvh.leaf_packed, fo, fd, fmin, fmax, any_hit))
        got = k1()
        torch.cuda.synchronize()
        err = compare_hits(f"K1 dynamic {name}", got, want, any_hit)[0]
        k1()  # warm-up
        ms = cuda_ms(k1, 20)
        dev = [device_ms(k1, TIMING_REPS) for _ in range(TIMING_ROUNDS)]
        dev_static = [device_ms(k1_static, TIMING_REPS) for _ in range(TIMING_ROUNDS)]
        counts = k1_walk_counts(traversal, bvh, front)
        bound = walk_bound(counts, bvh, "k1")
        dev_ms, static_ms = sorted(dev)[1], sorted(dev_static)[1]
        log(f"K1 dynamic tree front={name} rays={fd.shape[0]} hits={int((got[1] >= 0).sum())} "
            f"(plain {int((want[1] >= 0).sum())}) max_abs_err_t={err:.3e} k1_ms={ms:.4f} "
            f"(device alone {dev_ms:.4f}; the scene's tree on this front {static_ms:.4f}) "
            f"plain_ms={plain_ms:.3f}; its walk: {counts['iterations']} iterations, "
            f"{counts['box_tests']} slab and {counts['tri_tests']} triangle tests, lanes busy "
            f"{counts['lanes_busy']:.3f}; bound {bound['bound_ms']:.4f} ms "
            f"({bound['bound_by']}; {dev_ms / bound['bound_ms']:.1f}x)")
        out["max_abs_err"] = max(out["max_abs_err"], err)
        out[name] = dict(ms=dev_ms, bound_ms=bound["bound_ms"], static_ms=static_ms)
    return out


def mc_phase(Application, StaticConfig, create_scene, launches, counted, traversal, rays,
             pathtrace, mc_bvh) -> dict:
    """Config 5 (bench.py:251-253) at 1920x1080: the default scene, the
    bench's PT settings, mc_grid 32, the isosurface on. FRAMES host frames
    (launches: K1 12 closest + 10 any-hit, 5 seed, nothing else), the
    per-pass ms of one more frame, the MC material's pixels in the bench's
    view, the same frame with MC off in turns, and K1 on the dynamic tree's
    own fronts (`dyn_k1_phase`)."""
    torch.cuda.reset_peak_memory_stats()
    app = Application(WIDTH, HEIGHT, cfg=StaticConfig(**MC_CFG), device="cuda")
    app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
    app.create_scene(create_scene)
    counted.update(run_frames("config 5 (MC PT)", app, launches, MC_WANT)[0])
    outputs = pass_times("config 5 (MC PT)", app)
    material = app.renderer.ensure_mc_material()
    pixels = int((outputs["gbuffer"]["gbuffer_pbr"][..., 3] == material).sum())
    tables = outputs["mc_refit"]
    leaf_ids = tables["mc_leaf"][:, 9 * traversal.K1_LEAF_SLOTS:].contiguous().view(torch.int32)
    table_bytes = sum(t.numel() * t.element_size() for t in tables.values())
    log(f"config 5: {pixels} pixels of the MC material (id {material}) in the bench's view "
        f"(default camera); MC vertices {int(outputs['mc_extract']['marching_cubes_draw_count'][0])}"
        f", live triangle slots {int((leaf_ids >= 0).sum())} in {tables['mc_leaf'].shape[0]} "
        f"leaf rows, {tables['mc_wnode'].shape[0]} wide nodes; refit tables "
        f"{table_bytes / 2**20:.2f} MiB a frame ({LOOP_FRAMES * table_bytes / 2**20:.2f} MiB "
        f"stacked for a {LOOP_FRAMES}-frame device loop)")
    mc_frames_in_turns(app, launches, counted, MC_WANT,
                       Launches.frame_want(1 + BOUNCES, BOUNCES, 0, 0, seed=BOUNCES))
    dyn = mc_bvh.dynamic_scene_from_tables(tables, MC_CFG["mc_grid"], material)
    result = dyn_k1_phase(app, dyn, traversal, rays, pathtrace)
    log(f"config 5 peak device memory of this phase {torch.cuda.max_memory_allocated() / 2**30:.2f} "
        f"GiB (frames, per-pass frame, turns, the fronts and their walks)")
    return result


def mc_parity_phase(Application, StaticConfig) -> None:
    """One MC PT frame at MC_PARITY_SIZE (default scene, mc_grid 32, the
    camera on the MC region) on the CPU (plain versions) and on the card
    (K1 on both trees): the PT parity tolerance, equal pt_rays, and MC
    pixels in both."""
    frames = {}
    for device in ("cpu", "cuda"):
        app = Application(MC_PARITY_SIZE, MC_PARITY_SIZE,
                          cfg=StaticConfig(num_bounces=BOUNCES, mc_grid=MC_CFG["mc_grid"]),
                          device=device)
        app.fps_timer.elapsed_seconds = lambda: MC_TIME
        app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
        app.create_scene()
        app.camera.set_position_target(MC_EYE, MC_TARGET)
        res = app.render_frame()
        mc_px = int((res["gbuffer_pbr"][..., 3] == app.renderer.ensure_mc_material()).sum())
        frames[device] = (res["present_output"].cpu(), float(res["pt_rays"].cpu()), mc_px)
    (a, ra, pa), (b, rb, pb) = frames["cpu"], frames["cuda"]
    diff = (a - b).abs()
    within = float((diff.amax(dim=-1) <= 1e-3).float().mean())
    mean = float(diff.mean())
    log(f"MC PT parity {MC_PARITY_SIZE}x{MC_PARITY_SIZE}: MC pixels cpu={pa} cuda={pb}, rays "
        f"cpu={ra:.0f} cuda={rb:.0f} within_1e-3={within:.5f} mean_abs={mean:.3e} "
        f"max_abs={float(diff.max()):.3e}")
    if ra != rb or pa == 0 or pb == 0 or within < 0.99 or mean > 1e-3 \
            or not bool(torch.isfinite(b).all()):
        raise AssertionError("MC PT parity: card and CPU frames disagree")


def raster_gbuffer_planes(app, Graph, setup_gbuffer_pass, size: int, method=None) -> tuple:
    """(the raster gbuffer pass's planes, the visibility buffer they come
    from) at size x size. method None runs the pass itself
    (`setup_gbuffer_pass(use_raycast=False)`: K5 on the card, the brute
    path on the CPU); "binned" on the CPU gives its pieces with K5's plain
    version, `gbuffer.from_visibility` of `raster.rasterize(...,
    method="binned")`. Both read the visibility as the pass does."""
    from rust_renderer_tpu_torch.ops import gbuffer, raster
    from rust_renderer_tpu_torch.renderers.passes import GBUFFER_PLANES

    view = app.view.to(app.device)
    clip = raster.transform_vertices(app.scene.positions, view.projection @ view.view)
    vis = raster.rasterize(clip, app.scene.indices, size, size, method=method or "auto")
    if method is None:
        g = Graph(device=app.device)
        setup_gbuffer_pass(g, None, size, size, use_raycast=False)
        planes = g.render(app.scene, app.view)
    else:
        planes = dict(zip(GBUFFER_PLANES, gbuffer.from_visibility(app.scene, vis)))
    return {k: v.cpu() for k, v in planes.items()}, [x.cpu() for x in vis]


def raster_gbuffer_phase(Application, StaticConfig, Graph, setup_gbuffer_pass, launches,
                         counted) -> None:
    """The gbuffer pass's raster branch (`setup_gbuffer_pass(use_raycast=
    False)`: K5 over the scene, then `gbuffer.from_visibility`) on the
    default scene at 1920x1080: 3 frames, launches (K5 once a frame, nothing
    else), ms beside the ray-cast gbuffer (K1). Then at RASTER_PARITY_SIZE:

    - the card's pass against its CPU pieces with K5's plain version
      (`raster_gbuffer_planes(method="binned")`): triangle ids and material
      ids equal, every value within 1e-4 + 1e-4 relative (K5's
      barycentrics are within 1e-5 of its plain version's);
    - the card's pass against the CPU's pass, which rasterizes by the brute
      path (held to the JAX package's by tests/test_torch_raster_passes.py):
      printed, not gated. The two rasterizers pick another triangle on some
      pixels; the witness is that the CPU's own two rasterizers differ on
      exactly those pixels, and the depth gap between the two picks there."""
    app = Application(WIDTH, HEIGHT, cfg=StaticConfig(), device="cuda")
    app.create_scene()
    app._refresh_view()
    ms = {}
    for raycast in (False, True):
        g = Graph(device=app.device)
        setup_gbuffer_pass(g, app.scene_bvh, WIDTH, HEIGHT, use_raycast=raycast)
        g.render(app.scene, app.view)  # warm-up
        launches.reset()
        out = [timed(lambda: g.render(app.scene, app.view)) for _ in range(3)]
        got = launches.read()
        if not raycast:
            want = {k: 3 * v for k, v in Launches.frame_want(0, 0, 0, 1).items()}
            if got != want:
                raise AssertionError(f"raster gbuffer: launches {got}, expected {want}")
            counted.update(got)
            covered = float((out[-1][0]["gbuffer_depth"] < 1.0).float().mean())
        ms["raster (K5)" if not raycast else "ray cast (K1)"] = sorted(t for _, t in out)[1]
    log(f"raster gbuffer {WIDTH}x{HEIGHT}: covered share {covered:.4f}; pass ms (median of 3) "
        + ", ".join(f"{k} {v:.2f}" for k, v in ms.items()) + "; launches a frame {'k5': 1}")
    del app
    size = RASTER_PARITY_SIZE
    apps = {}
    for device in ("cpu", "cuda"):
        apps[device] = Application(size, size, cfg=StaticConfig(), device=device)
        apps[device].create_scene()
        apps[device]._refresh_view()
    card, card_vis = raster_gbuffer_planes(apps["cuda"], Graph, setup_gbuffer_pass, size)
    plain, plain_vis = raster_gbuffer_planes(apps["cpu"], Graph, setup_gbuffer_pass, size,
                                             "binned")
    brute, brute_vis = raster_gbuffer_planes(apps["cpu"], Graph, setup_gbuffer_pass, size)

    def shares(ref) -> tuple:
        parts, worst = [], 1.0
        for name, want in ref.items():
            got = card[name]
            within = float(torch.isclose(got, want, rtol=1e-4, atol=1e-4).float().mean())
            worst = min(worst, within)
            parts.append(f"{name} {within:.5f} (max |diff| "
                         f"{float((got - want).abs().max()):.3e})")
        return ", ".join(parts), worst

    text, worst = shares(plain)
    same_tri = torch.equal(card_vis[1], plain_vis[1])
    same_ids = torch.equal(card["gbuffer_pbr"][..., 3], plain["gbuffer_pbr"][..., 3])
    log(f"raster gbuffer parity {size}x{size} card vs CPU pieces (K5's plain version): "
        f"triangle ids {'equal' if same_tri else 'differ'}, material ids "
        f"{'equal' if same_ids else 'differ'}; share of values within 1e-4 + 1e-4 "
        f"relative: {text}")
    text, _ = shares(brute)
    picked = card_vis[1] != brute_vis[1]
    cpu_picked = plain_vis[1] != brute_vis[1]
    gap = (card_vis[0] - brute_vis[0]).abs()[picked]
    buckets = ", ".join(f"<= {t:g}: {int((gap <= t).sum())}" for t in (1e-6, 1e-5, 1e-4, 1e-3))
    log(f"raster gbuffer {size}x{size} card vs the CPU's pass (brute rasterizer): share of "
        f"values within 1e-4 + 1e-4 relative: {text}")
    log(f"raster gbuffer {size}x{size} tie witness: covered pixels "
        f"{int((brute_vis[1] >= 0).sum())}; card's triangle != brute's on {int(picked.sum())}, "
        f"the CPU's binned (K5's plain) != brute's on {int(cpu_picked.sum())}, the same pixels: "
        f"{torch.equal(picked, cpu_picked)}; one side uncovered there "
        f"{int((picked & ((card_vis[1] < 0) | (brute_vis[1] < 0))).sum())}; depth gap between "
        f"the two picks {buckets}, max {float(gap.max()) if gap.numel() else 0.0:.3e}")
    if worst < 1.0 or not same_ids or not same_tri or not torch.equal(picked, cpu_picked):
        raise AssertionError("raster gbuffer parity: card and CPU planes disagree")


# -- pass uniforms ---------------------------------------------------------------

# Frames compared and turns timed a mode; frames in the profiled window (a
# host and device trace of a 1080p raster frame takes ~8 s to process).
UNIFORM_FRAMES, UNIFORM_TURNS, UNIFORM_PROFILED = 3, 6, 1
UNIFORM_WANT = {"RASTERIZED": Launches.frame_want(2, 1, 4, 1, **RASTER_FRAME),
                "MINIMAL": Launches.frame_want(1, 0, 4, 0)}
# The values changed between builds (the defaults: radius 0.3, threshold 0.45).
UNIFORM_CHANGED = {"radius": 1.5, "fxaa_threshold": 2.0}


def literal_builder(graph, copies: list):
    """`graph.add_pass` that records a pass in the form before uniforms: each
    uniform value written as a literal that a 3-argument body copies to the
    card every frame (`torch.as_tensor`, one host-to-device copy a value,
    each appended to `copies`), the 4-argument body called with those
    tensors."""
    from rust_renderer_tpu_torch.graph import _NARROW, PassBuilder, _takes_uniforms

    class Literal(PassBuilder):
        def build(self):
            values = {k: np.array(v, _NARROW.get(np.asarray(v).dtype, np.asarray(v).dtype))
                      for k, v in self._uniforms.items()}
            if values and _takes_uniforms(self._fn):
                def literal(res, scene, view, *, fn=self._fn, values=values):
                    dev = view.view.device
                    copies.extend(values)
                    return fn(res, scene, view,
                              {k: torch.as_tensor(v, device=dev) for k, v in values.items()})
                self._fn, self._uniforms = literal, {}
            super().build()

    return lambda name: Literal(graph, name)


def uniform_app(Application, mode, literal: bool = False):
    """An Application of the default scene at 1920x1080 in `mode`
    (RASTERIZED with the marching-cubes draw), the clock pinned; with
    `literal`, its passes in the form before uniforms (`literal_builder`).
    `app.copies` lists the uniform copies its frames make: the uniform
    form's arena uploads (one a build), the literal form's values."""
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    mode = getattr(RenderGraphMode, mode)
    app = Application(WIDTH, HEIGHT, mode, device="cuda")
    app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
    app.view = app.view.replace(
        marching_cubes_enabled=np.int32(mode == RenderGraphMode.RASTERIZED))
    app.copies = []
    if literal:
        app.graph.add_pass = literal_builder(app.graph, app.copies)
    else:
        store = app.graph._uniforms
        upload = store.upload

        def counted_upload():
            app.copies.extend("upload" for a in store.arenas if a.dirty)
            upload()

        store.upload = counted_upload
    app.create_scene()
    return app


def with_values(app, values: dict):
    """app.render_frame() with the SSAO radius and FXAA threshold of
    `values`."""
    import rust_renderer_tpu_torch.renderers as builders
    from rust_renderer_tpu_torch.renderers import passes

    saved = builders.setup_ssao_pass, builders.setup_present_pass
    builders.setup_ssao_pass = functools.partial(passes.setup_ssao_pass,
                                                 radius=values["radius"])
    builders.setup_present_pass = functools.partial(
        passes.setup_present_pass, fxaa_threshold=values["fxaa_threshold"])
    try:
        return app.render_frame()
    finally:
        builders.setup_ssao_pass, builders.setup_present_pass = saved


def htod_copies(app, frames: int) -> tuple[float, dict, float]:
    """`frames` steady frames of `app` in one torch.profiler window (host
    and device activity): the host-to-device copies a frame (`Memcpy HtoD`
    events), their kinds (over all the frames), and the uniform copies a
    frame by the app's own count (`uniform_app`)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    app.copies.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(frames):
            app.render_frame()
        torch.cuda.synchronize()
    kinds = collections.Counter(e.name for e in prof.events() if "Memcpy HtoD" in e.name)
    return sum(kinds.values()) / frames, dict(kinds), len(app.copies) / frames


def uniforms_phase(Application, launches, counted) -> None:
    """The RASTERIZED (marching cubes on) and MINIMAL frames at 1920x1080
    with the builders' uniforms (device buffers of the graph, one copy a
    build) against the same frames with each value a literal that the body
    copies every frame (`literal_builder`), built in this run:
    1. UNIFORM_FRAMES frames of each, bit-equal, launches a frame as the
       main path's (counted);
    2. the SSAO radius and FXAA threshold changed between builds
       (UNIFORM_CHANGED): the next frame equals the same frame of an app
       built with those values from the start, and differs from the
       frame before the change;
    3. host-to-device copies of a steady frame of each form: the uniform
       copies by the app's own count (the uniform form must make one, from
       the pinned staging buffer, for all its values; the literal form one
       a value) and all of a frame's copies by torch.profiler (`Memcpy
       HtoD`; the view's fields are copied in both);
    4. frame ms of the two forms in turns (no gain is claimed: the raster
       frame is host-bound)."""
    for mode, want in UNIFORM_WANT.items():
        uniform, literal = (uniform_app(Application, mode, literal=f) for f in (False, True))
        for k in range(UNIFORM_FRAMES):
            launches.reset()
            got = uniform.render_frame()["present_output"]
            moved = launches.read()
            if moved != want:
                raise AssertionError(f"uniforms {mode}: launches {moved}, expected {want}")
            counted.update(moved)
            ref = literal.render_frame()["present_output"]
            if not torch.equal(got, ref):
                raise AssertionError(f"uniforms {mode}: frame {k + 1} differs from the literal "
                                     f"form's (max |diff| {float((got - ref).abs().max()):.3e})")
        check_image(f"uniforms {mode}", got)
        n_values = sum(len(p.uniforms) for p in uniform.graph.passes)
        if n_values == 0 or any(p.uniforms for p in literal.graph.passes):
            raise AssertionError(f"uniforms {mode}: {n_values} uniforms in the uniform form")
        before = got
        launches.reset()
        got = with_values(uniform, UNIFORM_CHANGED)["present_output"]
        counted.update(launches.read())
        fresh = uniform_app(Application, mode)
        launches.reset()
        for _ in range(UNIFORM_FRAMES + 1):
            ref = with_values(fresh, UNIFORM_CHANGED)["present_output"]
        counted.update(launches.read())
        if not torch.equal(got, ref) or torch.equal(got, before):
            raise AssertionError(f"uniforms {mode}: the frame after the values changed is not "
                                 "the frame of a graph built with them")
        del fresh
        copies = {name: htod_copies(app, UNIFORM_PROFILED)
                  for name, app in (("uniform", uniform), ("literal", literal))}
        staging = [a.staging for a in uniform.graph._uniforms.arenas]
        if (not staging or not all(b.is_pinned() for b in staging)
                or copies["uniform"][2] != 1 or copies["literal"][2] != n_values):
            raise AssertionError(f"uniforms {mode}: uniform copies a frame {copies}, "
                                 f"expected 1 (pinned) and {n_values}")
        log(f"uniforms {mode}: {UNIFORM_FRAMES} frames bit-equal to the literal form's; after "
            f"{UNIFORM_CHANGED} changed between builds, the frame equals a graph built with "
            f"them ({n_values} uniform values a frame); uniform copies a frame: uniform form "
            f"{copies['uniform'][2]:g} (from {len(staging)} pinned staging buffer), literal "
            f"form {copies['literal'][2]:g}; all host-to-device copies a frame "
            f"(torch.profiler, {UNIFORM_PROFILED} steady frame): uniform form "
            f"{copies['uniform'][0]:.2f} {copies['uniform'][1]}, literal form "
            f"{copies['literal'][0]:.2f} {copies['literal'][1]}")
        ms = in_turns({"uniform": lambda: uniform.render_frame(),
                       "literal": lambda: literal.render_frame()}, UNIFORM_TURNS)
        launches.reset()
        log(f"uniforms {mode}: frame ms in {UNIFORM_TURNS} turns (host clock around a frame "
            f"and a synchronize; the frames are host-bound): " + ", ".join(
                f"{k} median {v[0]:.1f} of {[round(x, 1) for x in v[1]]}" for k, v in ms.items()))
        del uniform, literal
        torch.cuda.empty_cache()


# -- the device loop, the bench's other scenes, the golden gates -----------------


def host_frames(app, n: int) -> tuple:
    """n frames through render_frame: the last present_output and the ms per
    frame, by CUDA events around all n."""
    out, ms = timed(lambda: [app.render_frame() for _ in range(n)][-1])
    return out["present_output"], ms / n


def twin_apps(Application, cfg, builder, mode, size=None, view=None, n: int = 2,
              group=None) -> list:
    """`n` Applications of one configuration and scene (at `size`, else
    WIDTH x HEIGHT), the clock pinned (view.time seeds every random
    stream), the view's fields `view` set, the graph row-sharded over
    `group` where given: one for the host loop, one for run_on_device."""
    apps = []
    for _ in range(n):
        app = Application(*(size or (WIDTH, HEIGHT)), mode, cfg=cfg, device="cuda")
        app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
        app.view = app.view.replace(**(view or {}))
        if group is not None:
            app.graph.shard_image_rows(group, *(size or (WIDTH, HEIGHT))[::-1])
        app.create_scene(builder)
        apps.append(app)
    return apps


def compare_loop(label: str, host, loop, host_img, loop_img, exact_only: bool = False) -> None:
    """The loop's state (accumulation, reservoirs, pt_rays) and last image
    against the host loop's: bit-equal, or within LOOP_ATOL (no float
    atomic is on the path, so any difference is a fault to name); with
    `exact_only`, bit-equal."""
    if set(host.graph.state) != set(loop.graph.state):
        raise AssertionError(f"{label}: the loop's state holds other resources")
    pairs = {name: (host.graph.state[name], loop.graph.state[name]) for name in host.graph.state}
    pairs["present_output"] = (host_img, loop_img)
    diff = {name: float((a.double() - b.double()).abs().max()) for name, (a, b) in pairs.items()}
    exact = all(torch.equal(a, b) for a, b in pairs.values())
    worst = max(diff, key=diff.get)
    log(f"{label}: state and image {'bit-equal' if exact else 'not bit-equal'} to the host "
        f"loop's ({len(pairs)} tensors; max |diff| {diff[worst]:.3e} in {worst})")
    if diff[worst] > LOOP_ATOL or (exact_only and not exact):
        raise AssertionError(f"{label}: the loop's {worst} differs from the host loop's")


def busy_share(fn) -> float | None:
    """The device's busy share of one torch.profiler window around fn(): the
    union of its kernel, copy and set intervals over the window's host time
    (fn() and a synchronize); None if the trace holds no device event. Only
    device activity is traced, so the host runs at its own pace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if str(e.device_type).endswith("CUDA"))
    if not spans:
        return None
    busy, end = 0.0, -1.0
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / wall_us


def share(x: float | None) -> str:
    return "not measured (no device event in the trace)" if x is None else f"{x:.3f}"


def loop_phase(label, Application, mode, cfg, builder, launches, counted, want: dict,
               view=None, group=None, busy_windows: bool = True) -> None:
    """An app at 1920x1080 (PT; a row-sharded RASTERIZED one in the tiles
    phase) through `run_on_device`, held to the host loop from one
    starting state: LOOP_FRAMES host frames against run_on_device(LOOP_FRAMES)
    (frame 1 eagerly, the capture, replays), then LOOP_FRAMES more of each
    (pure replay); the body must be captured once, the state equal. Launch
    counters: the first call moves two frames' worth (frame 1 and the
    capture's recording), a replay none, so a captured frame's launches are
    the eager frame's. Then ms per frame of each and the device's busy share
    of one profiled window of each. `view`: view fields set on both apps.
    The peak device memory of the first call is read with both apps'
    tensors resident. With `group` (an NCCL group), both apps' graphs are
    row-sharded over it: the captured body holds the collectives, and the
    loop must equal the host loop bit for bit. busy_windows=False skips the
    profiled windows (their traces take ~30 s to process)."""
    host, loop = twin_apps(Application, cfg, builder, mode, view=view, group=group)
    ms = {}
    for call in ("first call", "replay"):
        launches.reset()
        host_img, ms[f"host {call}"] = host_frames(host, LOOP_FRAMES)
        got = launches.read()
        if got != {k: v * LOOP_FRAMES for k, v in want.items()}:
            raise AssertionError(f"{label} host frames: launches {got}, expected {want} a frame")
        counted.update(got)
        launches.reset()
        torch.cuda.reset_peak_memory_stats()
        loop_img, loop_ms = timed(lambda: loop.run_on_device(LOOP_FRAMES, tstep=0.0))
        ms[f"loop {call}"] = loop_ms / LOOP_FRAMES
        if call == "first call":
            peak = torch.cuda.max_memory_allocated() / 2**30
        got = launches.read()
        moved = {k: v * (2 if call == "first call" else 0) for k, v in want.items()}
        if got != moved or loop.graph.last_loop_form != "captured" or loop.graph.captures != 1:
            raise AssertionError(
                f"{label} run_on_device ({call}): form {loop.graph.last_loop_form!r}, "
                f"{loop.graph.captures} captures, counters moved {got}, expected {moved}")
        counted.update(got)
        if host.total_samples != loop.total_samples:
            raise AssertionError(f"{label}: total_samples {loop.total_samples} after the "
                                 f"loop, {host.total_samples} after the host frames")
        compare_loop(f"{label} {call} ({LOOP_FRAMES} frames)", host, loop, host_img, loop_img,
                     exact_only=group is not None)
    busy = {"host": None, "loop": None}
    if busy_windows:
        busy = {"host": busy_share(lambda: host_frames(host, PROFILED_FRAMES)),
                "loop": busy_share(lambda: loop.run_on_device(PROFILED_FRAMES, tstep=0.0))}
    if loop.graph.captures != 1:
        raise AssertionError(f"{label}: the profiled window captured anew")
    log(f"{label}: form {loop.graph.last_loop_form}; ms per frame (CUDA events around "
        f"each call / {LOOP_FRAMES}): " + ", ".join(f"{k} {v:.2f}" for k, v in ms.items())
        + f"; replay / host {ms['loop replay'] / ms['host replay']:.3f}; peak device memory "
        f"of the first call {peak:.2f} GiB (both apps resident); device busy share "
        + (f"(one torch.profiler window of {PROFILED_FRAMES} frames, host clock): host loop "
           f"{share(busy['host'])}, captured loop {share(busy['loop'])}" if busy_windows
           else "not measured in this phase") + "; launches a frame "
        f"{ {k: v for k, v in want.items() if v} } (a captured frame's are the eager "
        f"frame's: replays move no counter)")


def raster_loop(label: str, app, launches, counted, want: dict) -> None:
    """RASTERIZED / MINIMAL through run_on_device on the main path's app (the
    frames carry no state; the clock pinned), against a host frame:
    run_on_device(LOOP_FRAMES) (frame 1 eagerly, the capture, replays), then
    a call of pure replay under torch.cuda.set_sync_debug_mode("error"), so
    that any host sync of a steady call raises. Each: form "captured", one
    capture, the counters moved by two frames' worth (`want` a frame) on
    the first call and by none on the replay, the last frame within
    LOOP_ATOL of the host frame. Then ms per frame of the host loop and of
    the replay, RASTER_TURNS turns of LOOP_FRAMES frames each, and the
    device's busy share of one profiled window of each."""
    app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
    host_img = app.render_frame()["present_output"]
    for call, moved in (("first call", 2), ("replay", 0)):
        launches.reset()
        mode = torch.cuda.get_sync_debug_mode()
        if call == "replay":
            torch.cuda.set_sync_debug_mode("error")
        try:
            img = app.run_on_device(LOOP_FRAMES, tstep=0.0)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        got = launches.read()
        counted.update(got)
        form, captures = app.graph.last_loop_form, app.graph.captures
        diff = float((img - host_img).abs().max())
        log(f"{label} run_on_device({LOOP_FRAMES}) {call}"
            f"{' under set_sync_debug_mode(error)' if call == 'replay' else ''}: form "
            f"{form!r}, {captures} capture(s), launches moved "
            f"{ {k: v for k, v in got.items() if v} }; last frame vs a host frame: "
            f"{'bit-equal' if torch.equal(img, host_img) else 'not bit-equal'}, "
            f"max |diff| {diff:.3e}")
        if (form != "captured" or captures != 1 or diff > LOOP_ATOL
                or got != {k: v * moved for k, v in want.items()}):
            raise AssertionError(f"{label}: the device loop's {call} is wrong")
    ms = {"host": [], "replay": []}
    for _ in range(RASTER_TURNS):
        ms["host"].append(host_frames(app, LOOP_FRAMES)[1])
        ms["replay"].append(timed(lambda: app.run_on_device(LOOP_FRAMES, tstep=0.0))[1]
                            / LOOP_FRAMES)
    busy = {"host": busy_share(lambda: host_frames(app, PROFILED_FRAMES)),
            "loop": busy_share(lambda: app.run_on_device(PROFILED_FRAMES, tstep=0.0))}
    if app.graph.captures != 1:
        raise AssertionError(f"{label}: the timed calls captured anew")
    med = {k: sorted(v)[len(v) // 2] for k, v in ms.items()}
    log(f"{label} device loop: ms per frame (CUDA events around {LOOP_FRAMES} frames) in "
        f"{RASTER_TURNS} turns: host loop {[round(x, 2) for x in ms['host']]}, replay "
        f"{[round(x, 2) for x in ms['replay']]}; medians {med['host']:.2f} / "
        f"{med['replay']:.2f}, replay / host {med['replay'] / med['host']:.3f}; device busy "
        f"share (one torch.profiler window of {PROFILED_FRAMES} frames, host clock): host "
        f"loop {share(busy['host'])}, captured loop {share(busy['loop'])}; launches a frame "
        f"{ {k: v for k, v in want.items() if v} }")


def scene_phase(Application, StaticConfig, RenderGraphMode, models, launches, counted) -> None:
    """The bench's other scenes at its sizes and settings (bench.py:101-105,
    :154-158): RTIOW PT at 256x256 (config 1), the cube scene RASTERIZED at
    512x512 (config 2) and the 128-light scene PT at 1920x1080 (config 4).
    Each: LOOP_FRAMES host frames (median ms of frames 2-N, launches a
    frame, pt_rays) and two run_on_device(LOOP_FRAMES) calls, the second
    timed (captured, the PT and raster loops alike: a replay moves no
    counter); the 128-light scene's per-pass ms of one more frame."""
    raster_cfg = {k: v for k, v in SPONZA_CFG.items() if k not in ("num_bounces",
                                                                   "samples_per_frame")}
    pt = RenderGraphMode.PATH_TRACED
    cases = (
        ("RTIOW PT", models.create_rtiow_scene, pt, (RTIOW_SIZE,) * 2, StaticConfig(**SPONZA_CFG),
         Launches.frame_want(BOUNCES, BOUNCES, 0, 0)),
        ("cube RASTERIZED", models.create_cube_scene, RenderGraphMode.RASTERIZED, (CUBE_SIZE,) * 2,
         StaticConfig(**raster_cfg),
         Launches.frame_want(2, 1, 4, 0, **RASTER_FRAME)),
        ("128-light PT", models.create_restir_many_lights_scene, pt, (WIDTH, HEIGHT),
         StaticConfig(**SPONZA_CFG), Launches.frame_want(1 + BOUNCES, BOUNCES, 0, 0,
                                                         seed=BOUNCES)),
    )
    for label, builder, mode, size, cfg, want in cases:
        label = f"{label} {size[0]}x{size[1]}"
        host, loop = twin_apps(Application, cfg, builder, mode, size)
        frame_ms = []
        launches.reset()
        for _ in range(LOOP_FRAMES):
            res, t = timed(host.render_frame)
            frame_ms.append(t)
        got = launches.read()
        if got != {k: v * LOOP_FRAMES for k, v in want.items()}:
            raise AssertionError(f"{label}: launches {got}, expected {want} a frame")
        counted.update(got)
        check = res["present_output"].float()
        if not bool(torch.isfinite(check).all()) or float(check.std()) <= 1e-3:
            raise AssertionError(f"{label}: the frame is not finite or is constant")
        rays = f", pt_rays {int(res['pt_rays'])}" if "pt_rays" in res else ""
        loop.run_on_device(LOOP_FRAMES, tstep=0.0)
        launches.reset()
        _, loop_ms = timed(lambda: loop.run_on_device(LOOP_FRAMES, tstep=0.0))
        moved = launches.read()
        counted.update(moved)
        if moved != dict.fromkeys(want, 0) or loop.graph.last_loop_form != "captured":
            raise AssertionError(f"{label}: run_on_device {loop.graph.last_loop_form!r} "
                                 f"moved the counters by {moved}")
        steady = sorted(frame_ms[1:])[len(frame_ms[1:]) // 2]
        log(f"{label}: host frames {[round(x, 2) for x in frame_ms]} ms (median of frames "
            f"2-{LOOP_FRAMES} {steady:.2f}), run_on_device {loop_ms / LOOP_FRAMES:.2f} ms a "
            f"frame ({loop.graph.last_loop_form}); launches a frame "
            f"{ {k: v for k, v in want.items() if v} }{rays}")
        if builder is models.create_restir_many_lights_scene:
            pass_times(label, host)
        del host, loop, res


def golden_phase(Application, StaticConfig, models, launches, counted) -> None:
    """The hermetic golden gates of tests/test_pathtrace_golden.py on the
    card: GOLD_FRAMES frames of 1 spp, GOLD_BOUNCES bounces, lights and RIS
    off, clock 0, through one run_on_device call (a captured loop: frame 1,
    the capture, replays), the accumulation over GOLD_FRAMES against the
    CPU tracer's image. RTIOW at 256x256 (:155-185): 8x8-block RMSE < 0.01,
    a 1.5% brightness bias caught (>= 0.008), sky / ground / centre mean
    energy within 1%. Cornell stand-in at 128x128 (:227-258): block RMSE <
    0.01, the bias caught (>= 0.006), red left and green right walls in
    both images, left / right / centre energy within 1.5%."""
    import os

    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "golden")

    def block(img):
        h, w, c = img.shape
        return img.reshape(h // 8, 8, w // 8, 8, c).mean(axis=(1, 3))

    for label, builder, size, file, floor in (
            ("RTIOW", models.create_rtiow_scene, 256, "rtiow_256_cpu_512spp.npy", 0.008),
            ("Cornell stand-in", models.create_cornell_standin_scene, 128,
             "cornell_128_cpu_384spp.npy", 0.006)):
        app = Application(size, size, cfg=StaticConfig(num_bounces=GOLD_BOUNCES),
                          device="cuda")
        app.fps_timer.elapsed_seconds = lambda: 0.0
        app.view = app.view.replace(lights_enabled=np.int32(0),
                                    use_ris_light_sampling=np.int32(0))
        app.create_scene(builder)
        launches.reset()
        _, ms = timed(lambda: app.run_on_device(GOLD_FRAMES, tstep=0.0))
        counted.update(launches.read())
        ours = (app.graph.state["accumulation_image"] / GOLD_FRAMES).cpu().numpy()
        ref = np.load(os.path.join(golden, file))
        a, b = block(ours), block(ref)
        rmse = float(np.sqrt(np.mean((a - b) ** 2)))
        biased = float(np.sqrt(np.mean((a * 1.015 - b) ** 2)))
        mid = slice(size // 3, 2 * size // 3)
        if builder is models.create_rtiow_scene:
            regions = {"sky": (slice(0, size // 6), slice(0, size)),
                       "ground": (slice(5 * size // 6, size), slice(0, size)),
                       "center": (mid, mid)}
            limit, walls = 0.01, True
        else:
            left, right = (mid, slice(0, size // 8)), (mid, slice(7 * size // 8, size))
            regions, limit = {"left": left, "right": right, "center": (mid, mid)}, 0.015
            walls = all(img[left][..., 0].mean() > img[left][..., 1].mean()
                        and img[right][..., 1].mean() > img[right][..., 0].mean()
                        for img in (ours, ref))
        energy = {name: abs(float(ours[sl].mean()) - float(ref[sl].mean()))
                  / max(float(ref[sl].mean()), 1e-6) for name, sl in regions.items()}
        log(f"golden {label} {size}x{size}, {GOLD_FRAMES} spp ({app.graph.last_loop_form}, "
            f"{ms / GOLD_FRAMES:.2f} ms a frame): 8x8-block RMSE {rmse:.5f} (< 0.01), with a "
            f"1.5% bias {biased:.5f} (>= {floor}), relative region energy "
            + ", ".join(f"{k} {v:.4f}" for k, v in energy.items()) + f" (< {limit})"
            + ("" if builder is models.create_rtiow_scene else f", wall colours {walls}"))
        if not (rmse < 0.01 and biased > rmse and biased >= floor and walls
                and max(energy.values()) < limit and app.graph.last_loop_form == "captured"):
            raise AssertionError(f"golden {label}: the gate fails")


# -- the application's own entry point ----------------------------------------


# Frames a main() run; pairs of host frames (sanitizer, profiler) and of
# run() calls (present_every) in turns.
APP_FRAMES, APP_FRAME_TURNS, APP_TURNS, APP_PRESENT_FRAMES, APP_PRESENT_EVERY = 4, 10, 3, 8, 4
APP_RTIOW_SIZE, APP_GLTF_SIZE, APP_SCOPE_CALLS = 256, 256, 20000
APP_GIZMO_MOVE = np.float32([0.6, -0.5, 1.2])
# main()'s frames at the StaticConfig defaults, the isosurface off (main() has
# the JAX package's flags, none of which turns it on): PT 6 + 5 K1 and 5
# seed a frame; RASTERIZED 2 + 1 K1, 4 K4, 1 seed (K5 draws the isosurface
# alone); MINIMAL 1 K1, 4 K4; RTIOW (no light, no triangle) 5 + 5 K1.
APP_WANT = {"pt": Launches.frame_want(1 + BOUNCES, BOUNCES, 0, 0, seed=BOUNCES, sky=PT_SKY),
            "raster": Launches.frame_want(2, 1, 4, 0, **RASTER_FRAME),
            "minimal": Launches.frame_want(1, 0, 4, 0)}
APP_RTIOW_WANT = Launches.frame_want(BOUNCES, BOUNCES, 0, 0, sky=PT_SKY)


def run_main(app_main, PROFILER, image_io, launches, counted, argv, want, size) -> object:
    """`main()` in-process by its command line `argv`, the counts zeroed just
    before and read just after: launches a frame must be `want`; prints the
    sanitizer report of the last frame, the written file's format and size
    (it must decode to the frame's), and the profiler's top scopes. Returns
    the Application main() made."""
    made = []

    class Recorded(app_main.Application):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            made.append(self)

    saved_argv, saved_app = sys.argv, app_main.Application
    sys.argv, app_main.Application = ["main", *argv], Recorded
    PROFILER.reset()
    launches.reset()
    t0 = time.perf_counter()
    try:
        rc = app_main.main()
    finally:
        sys.argv, app_main.Application = saved_argv, saved_app
    wall = time.perf_counter() - t0
    got = launches.read()
    counted.update(got)
    (app,) = made
    frames = int(argv[argv.index("--frames") + 1])
    label = " ".join(argv)
    per_frame = {k: v / frames for k, v in got.items()}
    img = image_io.read_image(app.saved_to)
    top = list(PROFILER.totals().items())[:6]
    log(f"app `main {label}`: rc {rc}, {wall:.2f} s of host time (scene build included); "
        f"launches a frame { {k: v for k, v in per_frame.items() if v} }; sanitizer report "
        f"of the last frame {app.graph.last_sanitizer_report}; wrote {app.saved_to} "
        f"({img.shape[1]}x{img.shape[0]}x{img.shape[2]} {img.dtype}); top scopes "
        + ", ".join(f"{name} {calls} calls {ms:.1f} ms" for name, (calls, ms) in top))
    if rc != 0 or got != {k: v * frames for k, v in want.items()}:
        raise AssertionError(f"app {label}: rc {rc}, launches {got}, expected {want} a frame")
    if img.shape != (size[1], size[0], 3) or img.std() <= 1.0:
        raise AssertionError(f"app {label}: the written image is {img.shape} or constant")
    return app


def host_ms(fn) -> float:
    """Host milliseconds of fn() and a synchronize (the step time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def in_turns(cases: dict, turns: int) -> dict:
    """Host ms of each case's fn, ABBA-ordered over `turns` pairs (frame times
    drift across a call, so cases are compared in turns); the medians."""
    names = list(cases)
    times = {k: [] for k in names}
    for i in range(turns):
        for name in (names if i % 2 == 0 else names[::-1]):
            times[name].append(host_ms(cases[name]))
    return {k: (sorted(v)[len(v) // 2], v) for k, v in times.items()}


def app_costs(app, PROFILER) -> None:
    """On the PT 1080p app main() made: a host frame with the sanitizer off
    and on, run(APP_PRESENT_FRAMES) with present_every 1 and
    APP_PRESENT_EVERY, and a frame with the profiler's timers on and off,
    each pair in turns (host clock and a synchronize); the sanitizer's report
    of each sanitized frame; one scope's host cost."""
    def frame(sanitize):
        app.graph.sanitize = sanitize
        app.render_frame()
        if sanitize and app.graph.last_sanitizer_report:
            log(f"app sanitizer: nonzero counts {app.graph.last_sanitizer_report}")

    med = in_turns({"off": lambda: frame(False), "on": lambda: frame(True)}, 2 * APP_FRAME_TURNS)
    log(f"app PT {WIDTH}x{HEIGHT} host frame, sanitize off / on (ms, host clock, in turns): "
        f"{[round(x, 2) for x in med['off'][1]]} / {[round(x, 2) for x in med['on'][1]]}; "
        f"medians {med['off'][0]:.2f} / {med['on'][0]:.2f} (on / off "
        f"{med['on'][0] / med['off'][0]:.4f}); {len(app.graph.passes)} passes, "
        f"{sum(1 for _ in app.graph.descs)} resources declared")
    app.graph.sanitize = False
    med = in_turns({f"every {k}": functools.partial(app.run, APP_PRESENT_FRAMES, present_every=k)
                    for k in (1, APP_PRESENT_EVERY)}, 2 * APP_TURNS)
    one, many = med["every 1"][0], med[f"every {APP_PRESENT_EVERY}"][0]
    log(f"app PT {WIDTH}x{HEIGHT} run({APP_PRESENT_FRAMES}) present_every 1 / {APP_PRESENT_EVERY} "
        f"(ms per frame, host clock, in turns): "
        f"{[round(x / APP_PRESENT_FRAMES, 2) for x in med['every 1'][1]]} / "
        f"{[round(x / APP_PRESENT_FRAMES, 2) for x in med[f'every {APP_PRESENT_EVERY}'][1]]}; "
        f"frames per second {1e3 * APP_PRESENT_FRAMES / one:.2f} / "
        f"{1e3 * APP_PRESENT_FRAMES / many:.2f} (ratio {one / many:.4f})")

    def profiled(enabled):
        PROFILER.enabled = enabled
        app.render_frame()

    try:
        med = in_turns({"on": lambda: profiled(True), "off": lambda: profiled(False)},
                       2 * APP_FRAME_TURNS)
    finally:
        PROFILER.enabled = True
    t0 = time.perf_counter()
    for _ in range(APP_SCOPE_CALLS):
        with PROFILER.scope("empty"):
            pass
    scope_us = (time.perf_counter() - t0) * 1e6 / APP_SCOPE_CALLS
    calls = sum(c for name, (c, _) in PROFILER.totals().items() if name != "empty")
    log(f"app profiler: PT {WIDTH}x{HEIGHT} host frame with the timers on / off (ms, in turns) "
        f"{med['on'][0]:.2f} / {med['off'][0]:.2f} (ratio {med['on'][0] / med['off'][0]:.4f}); "
        f"one empty scope {scope_us:.2f} us on the host (record_function and NVTX ranges "
        f"included); {calls} timed scopes so far")


def app_loop_sanitized(Application, StaticConfig, mode, create_scene, launches,
                       counted) -> None:
    """Two PT 1080p apps with sanitize on from one state: APP_FRAMES host
    frames, their reports summed, against run_on_device(APP_FRAMES), which
    must stay captured with a summed report equal to the host frames' and
    the state bit-equal; then the captured replay with sanitize on against
    a twin capture with it off, in turns."""
    cfg = StaticConfig(num_bounces=BOUNCES)
    host, loop = twin_apps(Application, cfg, create_scene, mode)
    for app in (host, loop):
        app.graph.sanitize = True
    summed = collections.Counter()
    launches.reset()
    for _ in range(APP_FRAMES):
        host.render_frame()
        summed.update(host.graph.last_sanitizer_report)
    loop.run_on_device(APP_FRAMES, tstep=0.0)
    counted.update(launches.read())
    log(f"app sanitized device loop: form {loop.graph.last_loop_form}, captures "
        f"{loop.graph.captures}, report {loop.graph.last_sanitizer_report} (host frames "
        f"summed {dict(summed)})")
    if (loop.graph.last_loop_form != "captured" or loop.graph.captures != 1
            or loop.graph.last_sanitizer_report != dict(summed)):
        raise AssertionError("app: the sanitized loop is not captured or reports otherwise")
    for name, t in host.graph.state.items():
        if not torch.equal(t, loop.graph.state[name]):
            raise AssertionError(f"app: the sanitized loop's {name} differs from the host's")
    del host
    (plain,) = twin_apps(Application, cfg, create_scene, mode, n=1)
    plain.run_on_device(APP_FRAMES, tstep=0.0)
    med = in_turns({"off": lambda: plain.run_on_device(APP_FRAMES, tstep=0.0),
                    "on": lambda: loop.run_on_device(APP_FRAMES, tstep=0.0)}, 2 * APP_TURNS)
    if loop.graph.captures != 1 or plain.graph.captures != 1:
        raise AssertionError("app: a replay in turns captured anew")
    log(f"app captured replay of {APP_FRAMES} frames, sanitize off / on (ms per frame, host "
        f"clock, in turns): {[round(x / APP_FRAMES, 3) for x in med['off'][1]]} / "
        f"{[round(x / APP_FRAMES, 3) for x in med['on'][1]]}; medians "
        f"{med['off'][0] / APP_FRAMES:.3f} / {med['on'][0] / APP_FRAMES:.3f} (on / off "
        f"{med['on'][0] / med['off'][0]:.4f})")


def app_gizmo(Application, StaticConfig, mode, create_scene, launches, counted) -> None:
    """The metal sphere moved by set_instance_transform on a host app and a
    loop app of one state (temporal reuse off in every app: a fresh app
    has no last frame's reservoirs): the next host frame bit-equal to the
    first frame of a fresh app built with the sphere there, the same view
    time; the next run_on_device captures anew (one capture more) and its
    state and image stay bit-equal to the host loop's."""
    cfg = StaticConfig(num_bounces=BOUNCES)
    off = dict(temporal_reuse_enabled=np.int32(0))
    host, loop = twin_apps(Application, cfg, create_scene, mode, view=off)
    metal = len(host.renderer.instances) - 2  # create_sponza_scene: metal, dielectric
    move = np.array(host.renderer.instances[metal].transform, np.float32)
    move[:3, 3] += APP_GIZMO_MOVE

    def moved(renderer, camera):
        create_scene(renderer, camera)
        renderer.set_instance_transform(metal, move)

    (fresh,) = twin_apps(Application, cfg, moved, mode, view=off, n=1)
    host_frames(host, 2)
    loop.run_on_device(2, tstep=0.0)
    for app in (host, loop):
        app.set_instance_transform(metal, move)
    launches.reset()
    after = host.render_frame()["present_output"]
    first = fresh.render_frame()["present_output"]
    counted.update(launches.read())
    same = torch.equal(after, first) and all(
        torch.equal(t, fresh.graph.state[n]) for n, t in host.graph.state.items())
    if not same or not torch.equal(host.scene.positions, fresh.scene.positions):
        raise AssertionError("app: the frame after the move differs from a fresh app's")
    want, _ = host_frames(host, APP_FRAMES - 1)
    launches.reset()
    img = loop.run_on_device(APP_FRAMES, tstep=0.0)
    counted.update(launches.read())
    if loop.graph.captures != 2 or loop.graph.last_loop_form != "captured":
        raise AssertionError(f"app: after the move the loop made {loop.graph.captures} "
                             "captures in all, expected 2")
    compare_loop("app gizmo: run_on_device after set_instance_transform", host, loop, want, img)
    log(f"app gizmo: instance {metal} (the metal sphere) moved by {APP_GIZMO_MOVE.tolist()}; "
        f"the next host frame bit-equal to a fresh app's first frame with the sphere there; "
        f"the loop captured anew ({loop.graph.captures} captures in all)")


def write_gltf(path, models) -> None:
    """A glTF of `models` [(Model, 4x4 world matrix)]: each mesh's positions,
    normals, uvs, indices and material factors, one node each with its
    matrix, every buffer in a data: URI."""
    import base64

    views, accessors, meshes, nodes, materials, blob = [], [], [], [], [], b""
    for model, matrix in models:
        for mesh in model.meshes:
            prim, attrs = mesh.primitive, {}
            for name, arr, kind, ctype in (
                    ("POSITION", prim.positions, "VEC3", 5126),
                    ("NORMAL", prim.normals, "VEC3", 5126),
                    ("TEXCOORD_0", prim.uvs, "VEC2", 5126),
                    ("indices", prim.indices.astype(np.uint32), "SCALAR", 5125)):
                data = np.ascontiguousarray(arr).tobytes()
                views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
                accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                                  "count": len(arr), "type": kind})
                attrs[name] = len(accessors) - 1
                blob += data
            m = mesh.material
            materials.append({"pbrMetallicRoughness": {
                "baseColorFactor": [float(x) for x in m.base_color_factor],
                "metallicFactor": float(m.metallic_factor),
                "roughnessFactor": float(m.roughness_factor)}})
            meshes.append({"primitives": [{"attributes": attrs, "indices": attrs.pop("indices"),
                                           "material": len(materials) - 1}]})
            nodes.append({"mesh": len(meshes) - 1,
                          "matrix": np.asarray(matrix, np.float32).T.reshape(-1).tolist()})
    uri = "data:application/octet-stream;base64," + base64.b64encode(blob).decode()
    with open(path, "w") as f:
        json.dump({"asset": {"version": "2.0"}, "scene": 0,
                   "scenes": [{"nodes": list(range(len(nodes)))}], "nodes": nodes,
                   "meshes": meshes, "materials": materials, "bufferViews": views,
                   "accessors": accessors, "buffers": [{"uri": uri, "byteLength": len(blob)}]},
                  f)


def app_gltf(Application, StaticConfig, tmp, launches, counted) -> None:
    """A glTF written to `tmp` (a floor, a cube and a sphere, node
    matrices) loaded by `load_gltf` and rendered (PT, APP_GLTF_SIZE², 2
    frames) against the same scene built from ModelLoader primitives: the
    packed scenes and the frames bit-equal."""
    import os

    from rust_renderer_tpu_torch.scene import ModelLoader, load_gltf
    from rust_renderer_tpu_torch.utils import math3d

    parts = [(ModelLoader.load_cube, math3d.scale([8.0, 0.1, 8.0])),
             (ModelLoader.load_cube, math3d.translation([0.6, 0.5, 0.0])),
             (lambda: ModelLoader.load_sphere(stacks=24, slices=48),
              math3d.translation([-0.7, 0.6, 0.3]) @ math3d.scale(0.6))]
    path = os.path.join(tmp, "scene.gltf")
    write_gltf(path, [(load(), m) for load, m in parts])

    def lights(r, cam):
        r.add_light([2.0, 3.0, 2.0], [1.0, 1.0, 1.0], 1.0)
        cam.set_position_target([3, 2, 5], [0, 0.5, 0])

    def from_gltf(r, cam):
        r.add_model(load_gltf(path), np.eye(4, dtype=np.float32))
        lights(r, cam)

    def from_primitives(r, cam):
        for load, m in parts:
            r.add_model(load(), m)
        lights(r, cam)

    imgs, apps = [], []
    for builder in (from_gltf, from_primitives):
        app = Application(APP_GLTF_SIZE, APP_GLTF_SIZE, cfg=StaticConfig(num_bounces=BOUNCES),
                          device="cuda")
        app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
        app.create_scene(builder)
        launches.reset()
        imgs.append(app.run(2))
        counted.update(launches.read())
        apps.append(app)
    packed = all(torch.equal(getattr(apps[0].scene, f), getattr(apps[1].scene, f))
                 for f in ("positions", "indices", "normals", "uvs"))
    log(f"app glTF: {os.path.getsize(path)} bytes, {apps[0].scene.num_triangles} triangles, "
        f"packed scene equal to the primitives' {packed}, frames bit-equal "
        f"{bool(np.array_equal(imgs[0], imgs[1]))} (mean {float(imgs[0].mean()):.4f})")
    if not packed or not np.array_equal(imgs[0], imgs[1]) or imgs[0].std() <= 1e-3:
        raise AssertionError("app glTF: the loaded scene renders otherwise")


def app_phase(Application, StaticConfig, RenderGraphMode, create_scene, launches,
              counted) -> None:
    """The application's own entry point on the card: `main()` by its command
    line at 1920x1080 with --sanitize for PT, RASTERIZED and MINIMAL on the
    default scene and PT on the RTIOW scene at 256x256; the sanitizer,
    present_every and profiler costs; the sanitized device loop; the gizmo;
    a glTF scene."""
    import tempfile

    from rust_renderer_tpu_torch.app import main as app_main
    from rust_renderer_tpu_torch.utils import image_io
    from rust_renderer_tpu_torch.utils.profiler import PROFILER

    with tempfile.TemporaryDirectory() as tmp:
        for mode, want in APP_WANT.items():
            argv = ["--width", str(WIDTH), "--height", str(HEIGHT), "--frames",
                    str(APP_FRAMES), "--sanitize", "--mode", mode, "--out", f"{tmp}/{mode}.png"]
            app = run_main(app_main, PROFILER, image_io, launches, counted, argv, want,
                           (WIDTH, HEIGHT))
            if mode == "pt":
                pt_app = app
            del app
        run_main(app_main, PROFILER, image_io, launches, counted,
                 ["--width", str(APP_RTIOW_SIZE), "--height", str(APP_RTIOW_SIZE), "--frames",
                  str(APP_FRAMES), "--sanitize", "--scene", "rtiow", "--out", f"{tmp}/rtiow.png"],
                 APP_RTIOW_WANT, (APP_RTIOW_SIZE, APP_RTIOW_SIZE))
        app_costs(pt_app, PROFILER)
        del pt_app
        pt = RenderGraphMode.PATH_TRACED
        app_loop_sanitized(Application, StaticConfig, pt, create_scene, launches, counted)
        app_gizmo(Application, StaticConfig, pt, create_scene, launches, counted)
        app_gltf(Application, StaticConfig, tmp, launches, counted)


# The tiles phase: row bands over torch.distributed ranks (parallel/). The
# sharded flagship frame's launches a frame on every rank; the row-sharded
# graphs' (PT; RASTERIZED with the marching-cubes draw; MINIMAL) and the
# largest |diff| of their gathered frames from one rank's.
TILES_RANKS, TILES_FRAMES = (2, 4), 2
# The gathered bands equal one rank's bit for bit (0 in every card run so
# far, as claimed): any difference fails.
TILES_ATOL = TILES_RASTER_ATOL = 0.0
FLAGSHIP_WANT = Launches.frame_want(1 + BOUNCES, BOUNCES, 0, 0, seed=BOUNCES, sky=PT_SKY)
TILES_GRAPHS = {"PATH_TRACED": (FLAGSHIP_WANT, TILES_ATOL),
                "RASTERIZED": (Launches.frame_want(2, 1, 4, 1, **RASTER_FRAME),
                               TILES_RASTER_ATOL),
                "MINIMAL": (Launches.frame_want(1, 0, 4, 0), TILES_RASTER_ATOL)}
# The row-sharded apps whose device loop the tiles phase runs.
TILES_LOOPS = ("PATH_TRACED", "RASTERIZED")


def flagship_inputs(app, bvh_ops):
    """The flagship chain's hit queries, built as the PT graph builds them
    (renderers/__init__.py: compaction windows, Morton order, the seed
    test's rows)."""
    cfg = app.cfg
    return (bvh_ops.make_closest_hit(app.scene_bvh, compact_window=cfg.compact_window,
                                     compact_order=cfg.compact_order),
            bvh_ops.make_any_hit(app.scene_bvh, compact_window=cfg.compact_window_any,
                                 compact_order=cfg.compact_order, seed_rows=cfg.seed_rows))


def flagship_frames(app, views, group=None) -> tuple:
    """TILES_FRAMES flagship frames of `app`'s scene from a zero state, one
    a view: through flagship_step (group None) or this rank's band through
    render_flagship_tiled. Returns the frames' (output, accumulation,
    spatial) bands, the ms of each frame by CUDA events and the bytes the
    chain gathered a frame."""
    from rust_renderer_tpu_torch.ops import bvh as bvh_ops
    from rust_renderer_tpu_torch.ops.restir import Reservoir
    from rust_renderer_tpu_torch.parallel import (
        flagship_step, render_flagship_tiled, shard_flagship_inputs, tiles)

    closest, any_hit = flagship_inputs(app, bvh_ops)
    accum = torch.zeros((HEIGHT, WIDTH, 3), device="cuda")
    res = Reservoir.empty((HEIGHT, WIDTH), device="cuda")
    if group is not None:
        accum, res = shard_flagship_inputs(group, accum, res)
    frames, ms, gathered = [], [], []
    for view in views:
        tiles.GATHERED_BYTES = 0
        if group is None:
            out, t = timed(lambda: flagship_step(app.scene, view, app.cfg, accum, res,
                                                 closest, any_hit))
        else:
            out, t = timed(lambda: render_flagship_tiled(app.scene, view, app.cfg, accum, res,
                                                         closest, any_hit, group))
        _, accum, res = out
        frames.append(out)
        ms.append(t)
        gathered.append(tiles.GATHERED_BYTES)
    return frames, ms, gathered


def tiles_app(Application, StaticConfig, mode, group=None):
    """An Application of the default scene at 1920x1080 (PT at 5 bounces),
    the clock pinned, the marching-cubes draw on in RASTERIZED; its graph
    row-sharded over `group` where given."""
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    mode = getattr(RenderGraphMode, mode)
    cfg = StaticConfig(num_bounces=BOUNCES) if mode == RenderGraphMode.PATH_TRACED else None
    app = Application(WIDTH, HEIGHT, mode, cfg=cfg, device="cuda")
    app.fps_timer.elapsed_seconds = lambda: PARITY_TIME
    app.view = app.view.replace(
        marching_cubes_enabled=np.int32(mode == RenderGraphMode.RASTERIZED))
    if group is not None:
        app.graph.shard_image_rows(group, HEIGHT, WIDTH)
    app.create_scene()
    return app


def tiles_rank(rank: int, n: int, view_fields: list, graphs: bool) -> dict:
    """One rank of the tiles phase (gloo over CUDA tensors, the ranks sharing
    the card): the flagship frame on its band, then, with `graphs`, the PT,
    RASTERIZED and MINIMAL frames of a row-sharded graph. Per frame: ms by
    CUDA events, launches, bytes gathered; the time of one flagship gather
    (4 planes) by the host clock; rank 0 also returns the gathered images
    and spatial Y."""
    import torch.distributed as dist

    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.convert import view_from_numpy
    from rust_renderer_tpu_torch.ops import bvh as bvh_ops, raster_binned, traversal
    from rust_renderer_tpu_torch.parallel import make_tile_group, tiles
    from rust_renderer_tpu_torch.settings import StaticConfig

    group, index = make_tile_group(backend="gloo", device="cuda")
    launches = Launches(traversal, raster_binned, bvh_ops)
    app = tiles_app(Application, StaticConfig, "PATH_TRACED")
    views = [view_from_numpy(v, "cuda") for v in view_fields]
    launches.reset()
    frames, ms, gathered = flagship_frames(app, views, group)
    out = {"index": index, "flagship_ms": ms, "gathered": gathered,
           "flagship_launches": launches.read()}
    spatial = frames[-1][2]
    [tiles.gather_rows(p, group) for p in spatial]  # the ranks in step
    torch.cuda.synchronize()
    dist.barrier(group)
    t0 = time.perf_counter()
    for _ in range(3):
        [tiles.gather_rows(p, group) for p in spatial]
    torch.cuda.synchronize()
    out["gather_ms"] = (time.perf_counter() - t0) / 3 * 1e3
    if index == 0:
        out["flagship"] = []
    for img, _, res in frames:
        whole = [tiles.gather_rows(img, group), tiles.gather_rows(res.Y, group)]
        if index == 0:
            out["flagship"].append([t.cpu() for t in whole])
    del app, frames, spatial
    if graphs:
        for mode in TILES_GRAPHS:
            app = tiles_app(Application, StaticConfig, mode, group)
            launches.reset()
            imgs, ms = [], []
            for _ in range(TILES_FRAMES):
                res, t = timed(app.render_frame)
                imgs.append(res["present_output"])
                ms.append(t)
            out[f"{mode}_launches"] = launches.read()
            out[f"{mode}_ms"] = ms
            out[f"{mode}_shape"] = tuple(imgs[-1].shape)
            whole = tiles.gather_rows(imgs[-1], group)
            if index == 0:
                out[mode] = whole.cpu()
            del app, imgs
        # The row-sharded PT and RASTERIZED apps through run_on_device: eager
        # over gloo.
        for mode in TILES_LOOPS:
            host, loop = (tiles_app(Application, StaticConfig, mode, group) for _ in range(2))
            host_img = [host.render_frame()
                        for _ in range(TILES_FRAMES)][-1]["present_output"]
            launches.reset()
            loop_img, t = timed(lambda: loop.run_on_device(TILES_FRAMES, tstep=0.0))
            pairs = [(a, loop.graph.state.get(n)) for n, a in host.graph.state.items()]
            out[f"{mode}_loop"] = {
                "launches": launches.read(), "form": loop.graph.last_loop_form,
                "ms": t / TILES_FRAMES, "exact": (
                    set(host.graph.state) == set(loop.graph.state)
                    and all(torch.equal(a, b) for a, b in pairs + [(host_img, loop_img)]))}
            del host, loop
    return out


def tiles_phase(Application, StaticConfig, launches, card: str) -> collections.Counter:
    """Row bands on torch.distributed (parallel/), the ranks sharing the one
    card: not a scaling figure, a check of the bands' frames, their launches
    and the collectives' cost.

    1. The PT Application's first TILES_FRAMES frames at 1920x1080 (their
       views recorded); flagship_step over the same views from the same zero
       state, and render_flagship_tiled over a one-rank NCCL group: the two
       bit-equal, and flagship_step bit-equal to the Application's frames
       (output and spatial Y).
    2. 2 and 4 gloo ranks over CUDA tensors, the same frames: rank 0's
       gathered output and spatial Y against step 1's (both bit-equal); per
       rank the frame ms, the K1 and seed launches
       (6 + 5 and 5 a frame), the bytes gathered a frame (2 x 16 B x H x W)
       and the time of one gather of the 4 planes.
    3. On the 2 ranks, PT, RASTERIZED (marching cubes on) and MINIMAL
       Applications whose graph is row-sharded (Graph.shard_image_rows):
       the gathered present_output of the last frame against the one-rank
       frame (bit-equal),
       per-rank frame ms and launches; then the row-sharded PT and
       RASTERIZED (marching cubes on) apps' run_on_device(TILES_FRAMES)
       against their twins' host frames: eager (gloo collectives cannot be
       captured), bit-equal, their launches.
    4. On the one-rank NCCL group, the row-sharded PT and RASTERIZED
       (marching cubes on) apps' device loops (`loop_phase` with the
       group): captured once, the collectives in the CUDA graph, bit-equal
       to the host loop, replay ms against the host loop's.
    Returns every launch of the phase (the ranks' included)."""
    import tempfile

    import torch.distributed as dist

    from rust_renderer_tpu_torch.models import create_scene
    from rust_renderer_tpu_torch.parallel import make_tile_group, spawn_ranks
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    counted = collections.Counter()
    app = tiles_app(Application, StaticConfig, "PATH_TRACED")
    views, render = [], app.graph.render

    def recording(scene, view):
        views.append(view)
        return render(scene, view)

    app.graph.render = recording
    launches.reset()
    want = []
    for _ in range(TILES_FRAMES):
        res = app.render_frame()
        want.append((res["present_output"], res["spatial_reuse_reservoirs_Y"].to(torch.int32)))
    counted.update(launches.read())
    device_views = [v.to("cuda") for v in views]
    launches.reset()
    single, single_ms, _ = flagship_frames(app, device_views)
    counted.update(launches.read())
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store", rank=0,
                                world_size=1)
        try:
            group, _ = make_tile_group(device="cuda")
            launches.reset()
            nccl, nccl_ms, nccl_bytes = flagship_frames(app, device_views, group)
            counted.update(launches.read())
            loop_phase("tiles: row-sharded PT device loop, one-rank NCCL group", Application,
                       RenderGraphMode.PATH_TRACED, StaticConfig(num_bounces=BOUNCES), create_scene,
                       launches, counted, FLAGSHIP_WANT, group=group, busy_windows=False)
            loop_phase("tiles: row-sharded RASTERIZED (marching cubes on) device loop, "
                       "one-rank NCCL group", Application, RenderGraphMode.RASTERIZED, None,
                       create_scene, launches, counted, TILES_GRAPHS["RASTERIZED"][0],
                       view=dict(marching_cubes_enabled=np.int32(1)), group=group,
                       busy_windows=False)
        finally:
            dist.destroy_process_group()
    for k, ((img, acc, sp), (n_img, n_acc, n_sp), (a_img, a_y)) in enumerate(
            zip(single, nccl, want)):
        exact = torch.equal(img, n_img) and torch.equal(acc, n_acc) and all(
            torch.equal(a, b) for a, b in zip(sp, n_sp))
        as_app = torch.equal(img, a_img) and torch.equal(sp.Y, a_y)
        log(f"tiles: flagship frame {k + 1} at {WIDTH}x{HEIGHT}: one-rank NCCL group "
            f"{'bit-equal' if exact else 'NOT bit-equal'} to flagship_step "
            f"({nccl_ms[k]:.1f} / {single_ms[k]:.1f} ms, {nccl_bytes[k]} bytes gathered); "
            f"against the PT Application's frame: output max |diff| "
            f"{float((img - a_img).abs().max()):.3e}, spatial Y unequal on "
            f"{int((sp.Y != a_y).sum())} pixels")
        if not exact:
            raise AssertionError("tiles: the one-rank NCCL flagship differs from flagship_step")
        if not as_app:
            raise AssertionError("tiles: flagship_step differs from the PT Application's frame")
    view_fields = [{f: np.asarray(getattr(v, f)) for f in vars(v)} for v in views]
    ref = [(img.cpu(), sp.Y.cpu()) for img, _, sp in single]
    graph_ref = {"PATH_TRACED": want[-1][0].cpu()}
    del app, single, nccl, want, device_views
    torch.cuda.empty_cache()
    for mode in list(TILES_GRAPHS)[1:]:
        app = tiles_app(Application, StaticConfig, mode)
        for _ in range(TILES_FRAMES):
            img = app.render_frame()["present_output"]
        graph_ref[mode] = img.cpu()
        del app

    for n in TILES_RANKS:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            ranks = spawn_ranks(tiles_rank, n, tmp, args=(view_fields, n == TILES_RANKS[0]))
            log(f"tiles: {n} gloo ranks on one card (CUDA tensors; ranks share the card: "
                f"not a scaling figure), spawn to join {time.perf_counter() - t0:.1f} s")
        for rank in ranks:
            got, want_ = rank["flagship_launches"], {
                k: v * TILES_FRAMES for k, v in FLAGSHIP_WANT.items()}
            log(f"tiles: {n} ranks, rank {rank['index']}: flagship frame ms "
                f"{[round(x, 2) for x in rank['flagship_ms']]}, launches "
                f"{ {k: v for k, v in got.items() if v} }, bytes "
                f"gathered a frame {rank['gathered']}, one gather of the 4 planes "
                f"{rank['gather_ms']:.2f} ms (two a frame)")
            if got != want_ or rank["gathered"] != [2 * 16 * HEIGHT * WIDTH] * TILES_FRAMES:
                raise AssertionError(f"tiles: {n} ranks: launches {got} (want {want_}) or "
                                     f"bytes {rank['gathered']}")
            counted.update(got)
        for k, ((img, y), (r_img, r_y)) in enumerate(zip(ranks[0]["flagship"], ref)):
            diff = (img - r_img).abs()
            log(f"tiles: {n} ranks, frame {k + 1} gathered: spatial Y unequal on "
                f"{int((y != r_y).sum())} pixels, output max |diff| {float(diff.max()):.3e}, "
                f"unequal pixels {int((diff.amax(-1) > 0).sum())}")
            if not torch.equal(y, r_y) or float(diff.max()) > TILES_ATOL:
                raise AssertionError(f"tiles: {n} ranks: frame {k + 1} differs from one rank")
        for mode, (per_frame, atol) in TILES_GRAPHS.items():
            if mode not in ranks[0]:
                continue
            want_ = {k: v * TILES_FRAMES for k, v in per_frame.items()}
            for rank in ranks:
                log(f"tiles: {n} ranks, rank {rank['index']}: {mode} row-sharded frame ms "
                    f"{[round(x, 2) for x in rank[f'{mode}_ms']]}, band "
                    f"{rank[f'{mode}_shape']}, launches "
                    f"{ {k: v for k, v in rank[f'{mode}_launches'].items() if v} }")
                if rank[f"{mode}_launches"] != want_:
                    raise AssertionError(f"tiles: {mode}: launches {rank[f'{mode}_launches']}"
                                         f", expected {want_}")
                counted.update(rank[f"{mode}_launches"])
            diff = float((ranks[0][mode] - graph_ref[mode]).abs().max())
            log(f"tiles: {n} ranks {mode} gathered present_output against one rank: max "
                f"|diff| {diff:.3e}")
            if diff > atol:
                raise AssertionError(f"tiles: {mode} row-sharded frame differs from one rank")
        for rank in ranks:
            for mode in TILES_LOOPS:
                got = rank.get(f"{mode}_loop")
                if got is None:
                    continue
                want_ = {k: v * TILES_FRAMES for k, v in TILES_GRAPHS[mode][0].items()}
                log(f"tiles: {n} gloo ranks, rank {rank['index']}: row-sharded {mode} "
                    f"run_on_device({TILES_FRAMES}) form {got['form']!r}, "
                    f"{'bit-equal' if got['exact'] else 'NOT bit-equal'} to the host loop, "
                    f"{got['ms']:.1f} ms a frame, launches "
                    f"{ {k: v for k, v in got['launches'].items() if v} }")
                if (not got["form"].startswith("eager: gloo collectives cannot be captured")
                        or not got["exact"] or got["launches"] != want_):
                    raise AssertionError(f"tiles: the gloo rank's sharded {mode} device loop "
                                         "is wrong")
                counted.update(got["launches"])
    log(f"tiles phase launches { {k: v for k, v in counted.items() if v} } ({card})")
    return counted


def build_kernels() -> str:
    """Versions and the card's line logged; every library that the port's
    modules declare (`native.LIBRARIES`) built, one compiler per library,
    all started together, and each compiler's report logged. Returns the
    card's line."""
    from rust_renderer_tpu_torch import native
    import rust_renderer_tpu_torch.app.main  # noqa: F401 (its ops declare every library)

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    card = card_line()
    t0 = time.perf_counter()
    libs = list(native.LIBRARIES.values())
    with concurrent.futures.ThreadPoolExecutor(len(libs)) as pool:
        for f in [pool.submit(lib.library) for lib in libs]:
            f.result()
    log(f"native build ({len(libs)} libraries in parallel) {time.perf_counter() - t0:.2f} s")
    for lib in libs:
        with open(f"{native.BUILD_DIR}/lib{lib.name}.so.log") as f:
            log(f.read().strip())
    return card


def app_alone() -> int:
    """`--app`: the kernels built, then the app phase alone (no kernels
    line; the last line {"ok": true, "card": ...})."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.models import create_scene
    from rust_renderer_tpu_torch.ops import bvh as bvh_ops, raster_binned, traversal
    from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig

    card = build_kernels()
    counted = collections.Counter()
    app_phase(Application, StaticConfig, RenderGraphMode, create_scene,
              Launches(traversal, raster_binned, bvh_ops), counted)
    log(f"app phase launches {dict(counted)}; chip_smoke --app total "
        f"{time.perf_counter() - START:.1f} s")
    print(json.dumps({"ok": True, "card": card}))
    return 0


RASTER_ALONE_ROUNDS = 5


def raster_alone() -> int:
    """`--raster`: the kernels built, then the RASTERIZED (marching cubes on)
    and MINIMAL apps of the main path at 1920x1080: FRAMES host frames
    (launches checked, `run_frames`) and RASTER_ALONE_ROUNDS frames with
    events around every pass (`pass_times`), with the median of each pass;
    no device loop, no kernels line; the last line {"ok": true, "card":
    ...}. It reads only what the port has had since its uniforms slice and
    builds what `native.LIBRARIES` declares, so a copy of this script beside
    another checkout's package that has them (its directory comes first on
    sys.path) measures that checkout's frames: parent against change in one
    call."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.ops import bvh as bvh_ops, raster_binned, traversal
    from rust_renderer_tpu_torch.settings import RenderGraphMode

    card = build_kernels()
    launches = Launches(traversal, raster_binned, bvh_ops)
    for label, mode, want in (
            ("RASTERIZED", RenderGraphMode.RASTERIZED,
             Launches.frame_want(2, 1, 4, 1, **RASTER_FRAME)),
            ("MINIMAL", RenderGraphMode.MINIMAL, Launches.frame_want(1, 0, 4, 0))):
        app = Application(WIDTH, HEIGHT, mode, device="cuda")
        app.view = app.view.replace(marching_cubes_enabled=np.int32(label == "RASTERIZED"))
        app.create_scene()
        if launches.sky is None:  # a port before the sky kernel's counter
            del want["sky"]
        if launches.deferred is None:  # a port before the deferred kernel
            del want["deferred"]
        if launches.ssao is None:  # a port before the SSAO kernels
            del want["ssao"]
        if not launches.bin:  # a port before the binning library
            del want["bin"]
        run_frames(label, app, launches, want)
        times = {}
        for _ in range(RASTER_ALONE_ROUNDS):
            pass_times(label, app, times)
        log(f"{label} per-pass ms, medians of {RASTER_ALONE_ROUNDS} frames: " + ", ".join(
            f"{name} {sorted(v)[len(v) // 2]:.2f}" for name, v in times.items()))
        del app
    log(f"chip_smoke --raster total {time.perf_counter() - START:.1f} s")
    print(json.dumps({"ok": True, "card": card}))
    return 0


def tiles_alone() -> int:
    """`--tiles`: the kernels built, then the tiles phase alone (no kernels
    line; the last line {"ok": true, "card": ...})."""
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch.ops import bvh as bvh_ops, raster_binned, traversal
    from rust_renderer_tpu_torch.settings import StaticConfig

    card = build_kernels()
    tiles_phase(Application, StaticConfig, Launches(traversal, raster_binned, bvh_ops), card)
    log(f"chip_smoke --tiles total {time.perf_counter() - START:.1f} s")
    print(json.dumps({"ok": True, "card": card}))
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no GPU", file=sys.stderr)
        return 1
    if sys.argv[1:] == ["--k5"]:
        return k5_alone()
    if sys.argv[1:] == ["--app"]:
        return app_alone()
    if sys.argv[1:] == ["--tiles"]:
        return tiles_alone()
    if sys.argv[1:] == ["--raster"]:
        return raster_alone()
    if sys.argv[1:] == ["--sky"]:
        return sky_alone()
    if sys.argv[1:] == ["--k4"]:
        return k4_alone()
    if sys.argv[1:] == ["--deferred"]:
        return deferred_alone()
    if sys.argv[1:] == ["--ssao"]:
        return ssao_alone()
    if sys.argv[1:]:
        print(f"chip_smoke: unknown arguments {sys.argv[1:]}", file=sys.stderr)
        return 2
    from rust_renderer_tpu_torch import native
    from rust_renderer_tpu_torch.app.main import Application
    from rust_renderer_tpu_torch import models
    from rust_renderer_tpu_torch.models import create_scene, create_sponza_scale_scene
    from rust_renderer_tpu_torch.graph import Graph
    from rust_renderer_tpu_torch.ops import (
        atmosphere, bvh as bvh_ops, compaction, marching_cubes, mc_bvh, pathtrace, raster,
        raster_binned, rays, shadow, traversal)
    from rust_renderer_tpu_torch.renderers.passes import setup_gbuffer_pass
    from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig

    card = build_kernels()
    launches = Launches(traversal, raster_binned, bvh_ops)
    counted = collections.Counter()
    fronts, bvhs = {}, {}

    # PATH_TRACED, at the StaticConfig defaults and with the schedules off.
    t0 = time.perf_counter()
    app = Application(WIDTH, HEIGHT, cfg=StaticConfig(num_bounces=BOUNCES), device="cuda")
    app.create_scene()
    log(f"PT: scene + BVH build {time.perf_counter() - t0:.3f} s, "
        f"{app.scene.num_triangles} triangles, {app.scene_bvh.wnode_packed.shape[0]} "
        f"wide nodes, wide depth {app.scene_bvh.wide_depth}")
    pt_schedules("PT", app, launches, counted, PT_SKY)
    fronts["default"] = make_fronts(app, traversal, rays, pathtrace)
    bvhs["default"] = app.scene_bvh
    k1 = k1_phase(app, traversal, fronts["default"])
    del app
    pt_want = Launches.frame_want(1 + BOUNCES, BOUNCES, 0, 0, seed=BOUNCES, sky=PT_SKY)
    loop_phase("PT device loop", Application, RenderGraphMode.PATH_TRACED,
               StaticConfig(num_bounces=BOUNCES), create_scene, launches, counted, pt_want)
    pt_parity_phase(Application, StaticConfig)

    # Config 5: PATH_TRACED with the traced marching-cubes isosurface.
    dyn_k1 = mc_phase(Application, StaticConfig, create_scene, launches, counted, traversal,
                      rays, pathtrace, mc_bvh)
    loop_phase("config 5 device loop", Application, RenderGraphMode.PATH_TRACED,
               StaticConfig(**MC_CFG), create_scene, launches, counted, MC_WANT,
               view=dict(marching_cubes_enabled=np.int32(1)))
    mc_parity_phase(Application, StaticConfig)

    # PATH_TRACED on the Sponza-scale scene, with the bench's settings.
    t0 = time.perf_counter()
    app = Application(WIDTH, HEIGHT, cfg=StaticConfig(**SPONZA_CFG), device="cuda")
    bvh_s = []
    build_scene_bvh = bvh_ops.build_scene_bvh

    def timed_build(scene):
        t = time.perf_counter()
        out = build_scene_bvh(scene)
        bvh_s.append(time.perf_counter() - t)
        return out

    bvh_ops.build_scene_bvh = timed_build  # the app's own build, timed
    try:
        app.create_scene(create_sponza_scale_scene)
    finally:
        bvh_ops.build_scene_bvh = build_scene_bvh
    build_s = time.perf_counter() - t0
    bvh = app.scene_bvh
    log(f"Sponza-scale PT: scene + BVH build {build_s:.3f} s (the BVH alone, w16 and q32 "
        f"collapses included, {bvh_s[0]:.3f} s on the host), "
        f"{app.scene.num_triangles} triangles, {bvh.wnode_packed.shape[0]} wide nodes, "
        f"wide depth {bvh.wide_depth} (K1 stack need {traversal.k1_stack_need(bvh.wide_depth)}"
        f" of {traversal.K1_STACK_CAP}), {bvh.wnode_q32.shape[0]} q32 nodes, q32 depth "
        f"{bvh.q32_depth}, binary depth {bvh.max_depth}")
    pt_schedules("Sponza-scale PT", app, launches, counted, 0)
    fronts["sponza_scale"] = make_fronts(app, traversal, rays, pathtrace)
    bvhs["sponza_scale"] = bvh
    log(f"Sponza-scale PT peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del app, bvh
    loop_phase("Sponza-scale PT device loop", Application, RenderGraphMode.PATH_TRACED,
               StaticConfig(**SPONZA_CFG), create_sponza_scale_scene, launches, counted,
               dict(pt_want, sky=0))

    # The traversal entry points under every kernel option, on both scenes;
    # then compaction and the seed test on the same fronts.
    variants = {scene: variants_phase(f"variants {scene}", bvhs[scene], fronts[scene],
                                      traversal, launches,
                                      k1["plain"] if scene == "default" else None)
                for scene in fronts}
    del k1["plain"]
    k1_table(variants)
    launches.reset()
    for scene in fronts:
        counted.update(compaction_phase(f"compaction {scene}", bvhs[scene], fronts[scene],
                                        traversal, compaction, launches))
    seeds = {scene: seed_phase(f"seed {scene}", bvhs[scene], fronts[scene], traversal, bvh_ops,
                               launches) for scene in fronts}
    del fronts, bvhs
    sky = sky_phase(atmosphere)
    deep = deep_tree_phase(traversal, bvh_ops, launches)

    # RASTERIZED with the marching-cubes draw.
    app = Application(WIDTH, HEIGHT, RenderGraphMode.RASTERIZED, device="cuda")
    app.view = app.view.replace(marching_cubes_enabled=np.int32(1))
    app.create_scene()
    counted.update(run_frames("RASTERIZED", app, launches,
                              Launches.frame_want(2, 1, 4, 1, **RASTER_FRAME))[0])
    gbuffer_depth = pass_times("RASTERIZED", app)["gbuffer"]["gbuffer_depth"]
    k4 = k4_phase(app, raster, raster_binned, shadow)
    k5 = k5_phase(app, raster, raster_binned, marching_cubes, gbuffer_depth)
    log(f"RASTERIZED peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    raster_loop("RASTERIZED", app, launches, counted,
                Launches.frame_want(2, 1, 4, 1, **RASTER_FRAME))
    del app, gbuffer_depth
    shade = deferred_phase(native)
    occlusion = ssao_phase(native)

    # MINIMAL.
    app = Application(WIDTH, HEIGHT, RenderGraphMode.MINIMAL, device="cuda")
    app.create_scene()
    counted.update(run_frames("MINIMAL", app, launches, Launches.frame_want(1, 0, 4, 0))[0])
    pass_times("MINIMAL", app)
    raster_loop("MINIMAL", app, launches, counted, Launches.frame_want(1, 0, 4, 0))
    del app
    uniforms_phase(Application, launches, counted)
    raster_parity_phase(Application, StaticConfig, RenderGraphMode)
    raster_gbuffer_phase(Application, StaticConfig, Graph, setup_gbuffer_pass, launches, counted)
    scene_phase(Application, StaticConfig, RenderGraphMode, models, launches, counted)
    golden_phase(Application, StaticConfig, models, launches, counted)
    counted.update(furnace_phase(Application, StaticConfig, launches))
    app_phase(Application, StaticConfig, RenderGraphMode, create_scene, launches, counted)
    counted.update(tiles_phase(Application, StaticConfig, launches, card))

    # Launches: the frames', the variant, compaction and seed runs' (every
    # path's count was read just after it); times and bounds on the default
    # scene's primary front (the seed kernel's on its NEE front); errors over
    # every front.
    kernels = []
    for key in dict.fromkeys(kernel for kernel, _ in VARIANTS.values()):
        labels = [name for name, (kernel, _) in VARIANTS.items() if kernel == key]
        runs = [variants[scene][name] for scene in variants for name in labels]
        launched = sum(r["launches"] for r in runs)
        err = max(r["max_abs_err"] for r in runs)
        if key == "k1":
            launched += counted["k1_closest"] + counted["k1_any_hit"]
            err = max(err, k1["max_abs_err"], dyn_k1["max_abs_err"])
        if key == "k2_sdd":
            launched += deep["launches"]
            err = max(err, deep["max_abs_err"])
        if key == "k3_wide_multi":
            launched += counted["k3_wide_multi"]
        shown = variants["default"][LINE_VARIANT.get(key, key)]
        kernels.append((key, launched, dict(shown, max_abs_err=err, outside_own_box=sum(
            r["outside_own_box"] for r in runs))))
    kernels += [("seed", counted["seed"] + sum(r["launches"] for r in seeds.values()),
                 seeds["default"]),
                ("k4", counted["k4"], k4), ("k5", counted["k5"], k5),
                ("sky", counted["sky"] + sky["launches"], sky),
                ("deferred", counted["deferred"] + shade["launches"], shade),
                ("ssao", counted["ssao"] + occlusion["launches"], occlusion)]
    names = {"k1": "k1_traverse_wide", "k4": "k4_depth_binned", "k5": "k5_vis_binned",
             "seed": "seed_occlusion", "sky": "sky_scatter", "deferred": "deferred_shade",
             "ssao": "ssao_occlusion"}
    line = []
    for key, launched, stats in kernels:
        source, replaces = SOURCES[key]
        line.append({"name": names.get(key, key), "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launched,
                     "max_abs_err": stats["max_abs_err"], "ms": stats["ms"],
                     "plain_ms": stats["plain_ms"], "bound_ms": stats["bound_ms"],
                     "bound_by": stats["bound_by"], "library_ms": None,
                     **({"outside_own_box": stats["outside_own_box"]}
                        if "outside_own_box" in stats else {}),
                     # K1 on config 5's dynamic tree, its primary front.
                     **({"dynamic_ms": dyn_k1["primary"]["ms"],
                         "dynamic_bound_ms": dyn_k1["primary"]["bound_ms"]}
                        if key == "k1" else {}),
                     **({k: stats[k] for k in ("registers", "spill_stores", "spill_loads")}
                        if key in ("deferred", "ssao") else {}),
                     **({k: stats[k] for k in ("depth_ms", "occlusion_ms")}
                        if key == "ssao" else {})})
        if launched == 0:
            raise AssertionError(f"{key} was never launched on a main path")
    log(f"chip_smoke total {time.perf_counter() - START:.1f} s")
    print(card)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
