"""Ray/BVH traversal: kernels K1, K1q, K2 and K3, and their plain PyTorch
version.

`traverse` answers, per ray, the nearest triangle hit in (t_min, t_max) as
(t, prim, u, v) — t = INF and prim = -1 on a miss — or, with any_hit=True,
whether anything is hit (prim >= 0). Its keyword options are the JAX
package's kernel options (`traverse_packet_pallas` as `ops/bvh.py::
make_closest_hit` calls it), and `select_kernel` names the kernel they
choose, by the JAX rule. CPU tensors take the plain version; CUDA tensors
launch the selected kernel or raise; any other device raises.

Every kernel is CUDA C++ (``csrc/``), one thread per ray, built with nvcc at
first use and bound with ctypes:

- K1 (``traverse_wide.cu``) walks the width-16 tree `wnode_packed` with a
  private stack, reading rows with 16-byte loads; a closest-hit walk tests
  a node's hit leaves nearest first and visits its inner children near to
  far, dropping any whose entry lies beyond the best hit. It replaces the
  TPU kernel ``rust_renderer_tpu/ops/pallas/traversal.py::_make_kernel_wide_row``.
- K1q (``traverse_q32.cu``) walks the quantized width-32 tree `wnode_q32`
  (``_make_kernel_wide_row32``).
- K2 (``traverse_drain.cu``) is the steady-drain walk of `wnode_packed`
  with a leaf queue (``_make_kernel_wide_sd`` / ``_sdd``); its stack and
  queue live in global scratch, so it takes trees of any depth.
- K3 is the JAX package's other schedules of the same walk: the binary
  skip walk and its ordered form over `node_packed`
  (``traverse_binary.cu``: ``_make_kernel``, ``_make_kernel_ordered``); the
  wide stack walk, ordered or dual, with an optional stats output
  (``traverse_wide.cu``: ``_make_kernel_wide``, ``_make_kernel_wide_dual``);
  the wide walk with a leaf queue flushed `leaf_queue` rows at a time
  (``traverse_lq.cu``: ``_make_kernel_wide_lq``, "K3-lq"); and the wide walk
  with `multi` rays interleaved per thread (``traverse_multi.cu``:
  ``_make_kernel_wide_multi``, "K3-multi").
- The plain version, `traverse_plain`, is the JAX package's own reference
  walk (``ops/bvh.py::traverse``): stackless over the binary tree
  `node_packed`. Every kernel computes its function; the wide ones walk
  another layout of the same tree, so their agreement is an independent
  check.

K1's stats form (`traverse(..., phase_stats=True)`) counts its own walk per
ray; it stands for the JAX row kernel's `phase_stats`, and
`overflow_stats` is always None, since K1 never clamps.

`K1_LAUNCHES` and `K1Q_LAUNCHES` count launches by query kind,
`K2_LAUNCHES` and `K3_LAUNCHES` by variant (K3-lq "wide_lq", K3-multi
"wide_multi"); nothing else changes them.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import os
import shutil

import torch

from rust_renderer_tpu_torch import native
from rust_renderer_tpu_torch.ops.rays import INF

CSRC = os.path.join(native.PACKAGE_DIR, "csrc")
COMMON = os.path.join(CSRC, "traverse_common.cuh")
SOURCES = {
    "k1_traverse_wide": os.path.join(CSRC, "traverse_wide.cu"),  # K1, K3 wide
    "k1q_traverse_q32": os.path.join(CSRC, "traverse_q32.cu"),
    "k2_traverse_drain": os.path.join(CSRC, "traverse_drain.cu"),
    "k3_traverse_binary": os.path.join(CSRC, "traverse_binary.cu"),
    "k3_traverse_lq": os.path.join(CSRC, "traverse_lq.cu"),
    "k3_traverse_multi": os.path.join(CSRC, "traverse_multi.cu"),
    # The seed test of ops/bvh.py::make_seed_test (no TPU kernel: XLA fused it).
    "seed_occlusion": os.path.join(CSRC, "seed_occlusion.cu"),
}
# Compile-time constants of the kernels (csrc/*.cu).
K1_STACK_CAP = 256
K3_STACK_CAP = 512
K3B_STACK_CAP = 256
K1Q_STACK_CAP = 64
# K3-lq's leaf queue per ray: a flush trigger of flush_k rows needs
# flush_k - 1 + K1_WIDTH of them (`lq_queue_need`).
LQ_QUEUE_CAP = 64
# K3-multi's rays per thread (each ray's stack is K3_STACK_CAP entries).
MULTI_WIDTHS = (2, 4, 8)
K1_LEAF_SLOTS = 12
K1_WIDTH = 16
THREADS = 128
# K2's leaf-queue rows per walker. A push onto a full queue tests its newest
# row first, so the cap drops nothing and bounds only the scratch; it is set
# above the per-ray peak depths that chip_smoke.py measures on the 1080p
# fronts with the queue uncapped (PERF.md). (The JAX kernel's SD_QCAP of
# 1024 is one queue for a whole 1024-ray packet.)
K2_QUEUE_CAP = 64
# K2's walkers per SM (16 blocks of THREADS): the grid strides over the rays.
K2_WALKERS_PER_SM = 2048

K1_LAUNCHES: collections.Counter = collections.Counter()  # by query kind
K1Q_LAUNCHES: collections.Counter = collections.Counter()  # by query kind
K2_LAUNCHES: collections.Counter = collections.Counter()  # "sd", "sdd"
K3_LAUNCHES: collections.Counter = collections.Counter()  # by variant

# select_kernel's names, and the counter each one moves.
KERNELS = ("k1", "k1q", "k2_sd", "k2_sdd", "k3_binary", "k3_binary_ordered",
           "k3_wide", "k3_wide_ordered", "k3_wide_dual", "k3_wide_lq",
           "k3_wide_multi")
# The JAX package's ray block (one (8, 128) packet) and its 2D tile side.
BLOCK = 1024
TILE = 32


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def nvcc_command() -> list[str]:
    return [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
            "-Xcompiler", "-fPIC"]


_ARGTYPES = {
    # rays (4), tables, then ints, outputs, stream
    "k1_traverse_wide": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 6,
    "k3_traverse_wide": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 6,
    "k1q_traverse_q32": [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 5,
    "k2_traverse_drain": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
    + [ctypes.c_void_p] * 2 + [ctypes.c_int] + [ctypes.c_void_p] * 6,
    "k3_traverse_binary": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
    + [ctypes.c_void_p] * 5,
    "k3_traverse_lq": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 6,
    "k3_traverse_multi": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
    + [ctypes.c_void_p] * 5,
    # rays (4), the host triangle table, then ints, the verdicts, the walk's
    # directions, stream
    "seed_occlusion": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2
    + [ctypes.c_void_p] * 3,
}


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """Build (at first use) and bind the traversal library `name`, a key of
    SOURCES."""
    lib = native.load_library(name, [SOURCES[name]], nvcc_command(), deps=(COMMON,))
    for fn_name, argtypes in _ARGTYPES.items():
        fn = getattr(lib, fn_name, None)
        if fn is not None:
            fn.restype = ctypes.c_int
            fn.argtypes = argtypes
    return lib


def _check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


def k1_stack_need(wide_depth: int) -> int:
    """Stack entries K1's walk of the width-16 tree can hold: a popped wide
    node defers up to WIDTH - 1 siblings per level, plus the WIDTH children
    of the last pop (the JAX package's bound)."""
    return (K1_WIDTH - 1) * int(wide_depth) + 2 * K1_WIDTH


def level_stack_need(levels: int, dual: bool) -> int:
    """Stack entries a wide walk can hold when its entries lie on `levels`
    levels of the tree. A pop's children go on top, so the stack stays
    sorted by level, and a level receives entries only from a pop that
    leaves nothing deeper on the stack: one node's WIDTH children, or two
    nodes' for a dual-pop walk. So each level holds at most WIDTH (dual:
    2 * WIDTH) entries."""
    return K1_WIDTH * (2 if dual else 1) * int(levels)


def _check_rays(kernel: str, o, d, t_min, t_max):
    """Device, dtype, shape and contiguity of (R,3) rays and (R,) limits."""
    dev = o.device
    r = o.shape[0]
    if dev.type != "cuda":
        raise ValueError(f"{kernel} runs on CUDA tensors, got {dev}")
    _check("origin", o, torch.float32, (r, 3), dev)
    _check("direction", d, torch.float32, (r, 3), dev)
    _check("t_min", t_min, torch.float32, (r,), dev)
    _check("t_max", t_max, torch.float32, (r,), dev)
    if r >= 2 ** 31:
        raise ValueError(f"{r} rays exceed one {kernel} launch")
    return r, dev


def _check_wide_tables(wnode_packed, leaf_packed, dev) -> None:
    _check("wnode_packed", wnode_packed, torch.float32,
           (wnode_packed.shape[0], 7 * K1_WIDTH), dev)
    _check("leaf_packed", leaf_packed, torch.float32,
           (leaf_packed.shape[0], 10 * K1_LEAF_SLOTS), dev)


def _hits(r: int, dev):
    return (torch.empty(r, dtype=torch.float32, device=dev),
            torch.empty(r, dtype=torch.int32, device=dev),
            torch.empty(r, dtype=torch.float32, device=dev),
            torch.empty(r, dtype=torch.float32, device=dev))


def _raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def traverse_wide_cuda(wnode_packed, leaf_packed, wide_depth: int, o, d,
                       t_min, t_max, any_hit: bool, stats: bool = False):
    """Launch K1 on (R,3) rays and (R,) limits, all contiguous float32 CUDA
    tensors on one device. Returns (t, prim, u, v) of shape (R,); with
    `stats`, K1's stats form, whose hits are the same, and a fifth (6, R)
    int32 tensor: per ray the loop iterations (entries popped, row 0), the
    entries expanded (row 1), the leaf rows tested (row 2), the pops
    dropped because their entry lies beyond the best hit (row 3), the
    child-box slab tests (row 4: non-empty slots of the expanded nodes) and
    the triangle tests (row 5: live leaf slots reached)."""
    r, dev = _check_rays("K1", o, d, t_min, t_max)
    _check_wide_tables(wnode_packed, leaf_packed, dev)
    need = k1_stack_need(wide_depth)
    if need > K1_STACK_CAP:
        raise ValueError(
            f"tree of wide depth {wide_depth} needs a {need}-entry stack; "
            f"K1 is built with {K1_STACK_CAP}")
    for name, table in (("wnode_packed", wnode_packed), ("leaf_packed", leaf_packed)):
        if table.data_ptr() % 16:
            raise ValueError(f"K1 reads {name} with 16-byte loads: it must be 16-byte aligned")
    out = _hits(r, dev)
    st = torch.empty((6, r), dtype=torch.int32, device=dev) if stats else None
    if r:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library("k1_traverse_wide").k1_traverse_wide(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            wnode_packed.data_ptr(), leaf_packed.data_ptr(), r, int(any_hit),
            *(x.data_ptr() for x in out), st.data_ptr() if stats else None, stream)
        _raise_on(err, "K1")
        K1_LAUNCHES["any_hit" if any_hit else "closest"] += 1
    return (*out, st) if stats else out


def traverse_wide_k3_cuda(wnode_packed, leaf_packed, wide_depth: int, o, d,
                          t_min, t_max, any_hit: bool, ordered: bool = False,
                          dual: bool = False, stats: bool = False):
    """Launch K3's wide stack walk (ordered, dual, or neither). Returns
    (t, prim, u, v), with stats a fifth (4, R) int32 tensor: per ray the
    entries popped (row 0) and the leaf rows popped (row 1), the row
    meaning of the JAX stats output, which counts per 1024-ray packet; then
    the child-box slab tests (row 2: non-empty slots of the popped nodes)
    and the triangle tests (row 3: non-empty leaf slots reached) that the
    walk performs."""
    if ordered and dual:
        raise ValueError("K3's wide walk is ordered or dual, not both")
    r, dev = _check_rays("K3", o, d, t_min, t_max)
    _check_wide_tables(wnode_packed, leaf_packed, dev)
    need = level_stack_need(wide_depth + 1, dual)  # leaf refs are entries too
    if need > K3_STACK_CAP:
        raise ValueError(
            f"tree of wide depth {wide_depth} needs a {need}-entry stack; "
            f"K3 is built with {K3_STACK_CAP}")
    out = _hits(r, dev)
    st = torch.empty((4, r), dtype=torch.int32, device=dev) if stats else None
    if r:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library("k1_traverse_wide").k3_traverse_wide(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            wnode_packed.data_ptr(), leaf_packed.data_ptr(), r, int(any_hit),
            int(ordered), int(dual), *(x.data_ptr() for x in out),
            st.data_ptr() if stats else None, stream)
        _raise_on(err, "K3")
        K3_LAUNCHES["wide_ordered" if ordered else "wide_dual" if dual else "wide"] += 1
    return (*out, st) if stats else out


def lq_queue_need(flush_k: int) -> int:
    """Leaf-queue rows K3-lq needs with a flush trigger of `flush_k`: the
    queue holds fewer than flush_k rows before a pop, a pop appends at most
    K1_WIDTH, and a flush takes up to K1_WIDTH (the JAX kernel's rule), so
    it never holds more than flush_k - 1 + K1_WIDTH."""
    return int(flush_k) - 1 + K1_WIDTH


def traverse_lq_cuda(wnode_packed, leaf_packed, wide_depth: int, o, d, t_min,
                     t_max, any_hit: bool, flush_k: int, stats: bool = False):
    """Launch K3-lq, the wide walk whose stack holds internal nodes only: a
    popped node's hit leaf children go to a per-ray queue, flushed (up to
    K1_WIDTH rows, newest first) once it holds `flush_k` rows or the stack
    is empty. Returns (t, prim, u, v), with stats a fifth (4, R) int32
    tensor: per ray the internal nodes popped, the leaf rows tested, and
    the slab and triangle tests, as K3 wide's stats count them."""
    r, dev = _check_rays("K3-lq", o, d, t_min, t_max)
    _check_wide_tables(wnode_packed, leaf_packed, dev)
    if flush_k < 1:
        raise ValueError(f"K3-lq flushes at least one leaf row, got flush_k={flush_k}")
    if lq_queue_need(flush_k) > LQ_QUEUE_CAP:
        raise ValueError(f"flush_k={flush_k} needs a {lq_queue_need(flush_k)}-row leaf "
                         f"queue; K3-lq is built with {LQ_QUEUE_CAP}")
    need = level_stack_need(wide_depth, False)  # internal nodes only
    if need > K3_STACK_CAP:
        raise ValueError(f"tree of wide depth {wide_depth} needs a {need}-entry stack; "
                         f"K3-lq is built with {K3_STACK_CAP}")
    out = _hits(r, dev)
    st = torch.empty((4, r), dtype=torch.int32, device=dev) if stats else None
    if r:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library("k3_traverse_lq").k3_traverse_lq(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            wnode_packed.data_ptr(), leaf_packed.data_ptr(), r, int(any_hit),
            int(flush_k), *(x.data_ptr() for x in out),
            st.data_ptr() if stats else None, stream)
        _raise_on(err, "K3-lq")
        K3_LAUNCHES["wide_lq"] += 1
    return (*out, st) if stats else out


def multi_rays(ray_shape, multi: int) -> int:
    """The rays one K3-multi thread walks for a front of `ray_shape`: the
    JAX package's ray blocks per grid step (`traverse_packet_pallas`,
    ``:2757-2759``). A 2D front whose sides are multiples of TILE packs into
    H*W/BLOCK blocks, and `multi` halves until it divides that count; any
    other front is padded to a multiple of BLOCK * multi rays, so its block
    count always divides."""
    nb = max(int(multi), 1)
    shape = tuple(ray_shape)
    if len(shape) == 2 and shape[0] % TILE == 0 and shape[1] % TILE == 0:
        blocks = shape[0] * shape[1] // BLOCK
        while nb > 1 and blocks % nb:
            nb //= 2
    return nb


def traverse_multi_cuda(wnode_packed, leaf_packed, wide_depth: int, o, d, t_min,
                        t_max, any_hit: bool, m: int):
    """Launch K3-multi: K3 wide's walk with `m` rays per thread, each with
    its own stack; each iteration pops one entry of every ray still
    walking. Returns (t, prim, u, v)."""
    r, dev = _check_rays("K3-multi", o, d, t_min, t_max)
    _check_wide_tables(wnode_packed, leaf_packed, dev)
    if m not in MULTI_WIDTHS:
        raise ValueError(f"K3-multi is built for {MULTI_WIDTHS} rays per thread, got {m}")
    need = level_stack_need(wide_depth + 1, False)  # leaf refs are entries too
    if need > K3_STACK_CAP:
        raise ValueError(f"tree of wide depth {wide_depth} needs a {need}-entry stack; "
                         f"K3-multi is built with {K3_STACK_CAP}")
    out = _hits(r, dev)
    if r:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library("k3_traverse_multi").k3_traverse_multi(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            wnode_packed.data_ptr(), leaf_packed.data_ptr(), r, int(any_hit), int(m),
            *(x.data_ptr() for x in out), stream)
        _raise_on(err, "K3-multi")
        K3_LAUNCHES["wide_multi"] += 1
    return out


def traverse_drain_cuda(wnode_packed, leaf_packed, wide_depth: int, o, d,
                        t_min, t_max, any_hit: bool, drain: int = 3,
                        dual: bool = True, drain_first: bool = False,
                        stats: bool = False, queue_cap: int = K2_QUEUE_CAP):
    """Launch K2, the steady-drain walk: one (dual: two) expands and up to
    `drain` leaf rows per iteration, with a leaf queue of `queue_cap` rows
    per walker. Returns (t, prim, u, v), with stats a fifth (3, R) int32
    tensor: per ray the internal nodes popped, the leaf rows tested and the
    peak queue depth (rows 0-2 of the JAX stats)."""
    r, dev = _check_rays("K2", o, d, t_min, t_max)
    _check_wide_tables(wnode_packed, leaf_packed, dev)
    if drain < 1:
        raise ValueError(f"K2 drains at least one leaf row per iteration, got {drain}")
    if queue_cap < 1:
        raise ValueError(f"K2's leaf queue holds at least one row, got {queue_cap}")
    stack_cap = level_stack_need(wide_depth, dual)  # internal nodes only
    out = _hits(r, dev)
    st = torch.empty((3, r), dtype=torch.int32, device=dev) if stats else None
    if r:
        walkers = k2_walkers(r, dev)
        stack = torch.empty((stack_cap, walkers), dtype=torch.int32, device=dev)
        queue = torch.empty((queue_cap, walkers), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library("k2_traverse_drain").k2_traverse_drain(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            wnode_packed.data_ptr(), leaf_packed.data_ptr(), r, int(any_hit),
            int(drain), int(dual), int(drain_first), walkers // THREADS,
            stack.data_ptr(), queue.data_ptr(), queue_cap, *(x.data_ptr() for x in out),
            st.data_ptr() if stats else None, stream)
        _raise_on(err, "K2")
        K2_LAUNCHES["sdd" if dual else "sd"] += 1
    return (*out, st) if stats else out


def k2_walkers(r: int, dev) -> int:
    """K2's grid, in threads, for `r` rays: at most K2_WALKERS_PER_SM per
    SM, whole blocks of THREADS. Each walker owns a column of the scratch."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    return -(-min(r, sms * K2_WALKERS_PER_SM) // THREADS) * THREADS


def traverse_q32_cuda(wnode_q32, wnode_meta32, q32_leaf_perm, leaf_packed,
                      q32_depth: int, o, d, t_min, t_max, any_hit: bool):
    """Launch K1q over the quantized width-32 tree. Returns (t, prim, u, v)."""
    r, dev = _check_rays("K1q", o, d, t_min, t_max)
    n = wnode_q32.shape[0]
    _check("wnode_q32", wnode_q32, torch.int32, (n, 128), dev)
    _check("wnode_meta32", wnode_meta32, torch.int32, (n + 1, 4), dev)
    _check("q32_leaf_perm", q32_leaf_perm, torch.int32, (q32_leaf_perm.shape[0],), dev)
    _check("leaf_packed", leaf_packed, torch.float32,
           (leaf_packed.shape[0], 10 * K1_LEAF_SLOTS), dev)
    if q32_depth + 1 > K1Q_STACK_CAP:
        raise ValueError(f"q32 tree of depth {q32_depth} needs {q32_depth + 1} "
                         f"stack entries; K1q is built with {K1Q_STACK_CAP}")
    out = _hits(r, dev)
    if r:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library("k1q_traverse_q32").k1q_traverse_q32(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            wnode_q32.data_ptr(), wnode_meta32.data_ptr(), q32_leaf_perm.data_ptr(),
            leaf_packed.data_ptr(), n, r, int(any_hit),
            *(x.data_ptr() for x in out), stream)
        _raise_on(err, "K1q")
        K1Q_LAUNCHES["any_hit" if any_hit else "closest"] += 1
    return out


def traverse_binary_cuda(node_packed, leaf_packed, max_depth: int, o, d,
                         t_min, t_max, any_hit: bool, ordered: bool = False):
    """Launch K3's binary walk over `node_packed`: the skip walk, or with
    `ordered` the near-child-first stack walk. Returns (t, prim, u, v)."""
    r, dev = _check_rays("K3", o, d, t_min, t_max)
    n = node_packed.shape[0]
    _check("node_packed", node_packed, torch.float32, (n, 8), dev)
    _check("leaf_packed", leaf_packed, torch.float32,
           (leaf_packed.shape[0], 10 * K1_LEAF_SLOTS), dev)
    if ordered and max_depth + 2 > K3B_STACK_CAP:
        raise ValueError(f"binary tree of depth {max_depth} needs {max_depth + 2} "
                         f"stack entries; K3 is built with {K3B_STACK_CAP}")
    out = _hits(r, dev)
    if r:
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = library("k3_traverse_binary").k3_traverse_binary(
            o.data_ptr(), d.data_ptr(), t_min.data_ptr(), t_max.data_ptr(),
            node_packed.data_ptr(), leaf_packed.data_ptr(), n, r, int(any_hit),
            int(ordered), *(x.data_ptr() for x in out), stream)
        _raise_on(err, "K3")
        K3_LAUNCHES["binary_ordered" if ordered else "binary"] += 1
    return out


def _safe_inv(a: torch.Tensor) -> torch.Tensor:
    return 1.0 / torch.where(a.abs() < 1e-12, torch.where(a < 0, -1e-12, 1e-12), a)


def traverse_plain(node_packed, leaf_packed, o, d, t_min, t_max, any_hit: bool):
    """Stackless walk over the binary skip-pointer tree (the JAX package's
    ``ops/bvh.py::traverse``), vectorized over the rays still walking.

    o, d: (R,3); t_min, t_max: (R,). Returns (t, prim, u, v) of shape (R,).
    A ray at an internal node whose box it hits moves to node + 1, else to
    the node's skip pointer; at a leaf it tests every slot. Within a leaf
    the earlier slot keeps a tie, as the JAX walk's sequential slot loop
    does.
    """
    dev = o.device
    r = o.shape[0]
    ls = leaf_packed.shape[1] // 10
    node_i = node_packed.view(torch.int32)
    leaf_ids = leaf_packed[:, 9 * ls:].contiguous().view(torch.int32)
    leaf_geo = leaf_packed[:, :9 * ls].reshape(-1, ls, 9)
    inv = _safe_inv(d)
    slot_index = torch.arange(ls, device=dev)

    best_t = torch.clamp_max(t_max, INF).clone()
    best_prim = torch.full((r,), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros(r, dtype=torch.float32, device=dev)
    best_v = torch.zeros(r, dtype=torch.float32, device=dev)
    degenerate = (d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]) < 1e-12
    live = torch.nonzero(~degenerate).squeeze(1)
    cur = torch.zeros(live.shape[0], dtype=torch.int64, device=dev)

    while live.numel():
        row = node_packed[cur]
        oo, ii = o[live], inv[live]
        t0 = (row[:, 0:3] - oo) * ii
        t1 = (row[:, 3:6] - oo) * ii
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        tnear = torch.maximum(torch.maximum(lo[:, 0], lo[:, 1]), lo[:, 2])
        tfar = torch.minimum(torch.minimum(hi[:, 0], hi[:, 1]), hi[:, 2])
        box_hit = ((tfar >= torch.maximum(tnear, t_min[live]))
                   & (tnear <= best_t[live]))
        miss = node_i[cur, 6].to(torch.int64)
        leaf = node_i[cur, 7].to(torch.int64)
        is_leaf = leaf >= 0
        finished = torch.zeros_like(box_hit)

        at_leaf = torch.nonzero(box_hit & is_leaf).squeeze(1)
        if at_leaf.numel():
            lanes = live[at_leaf]
            rows = leaf_geo[leaf[at_leaf]]  # (k, ls, 9)
            ids = leaf_ids[leaf[at_leaf]]  # (k, ls)
            ox, oy, oz = (o[lanes, j][:, None] for j in range(3))
            dx, dy, dz = (d[lanes, j][:, None] for j in range(3))
            v0x, v0y, v0z = rows[..., 0], rows[..., 1], rows[..., 2]
            e1x, e1y, e1z = rows[..., 3], rows[..., 4], rows[..., 5]
            e2x, e2y, e2z = rows[..., 6], rows[..., 7], rows[..., 8]
            px = dy * e2z - dz * e2y
            py = dz * e2x - dx * e2z
            pz = dx * e2y - dy * e2x
            det = e1x * px + e1y * py + e1z * pz
            inv_det = torch.where(det.abs() > 1e-12, 1.0 / det, 0.0)
            tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
            u = (tvx * px + tvy * py + tvz * pz) * inv_det
            qx = tvy * e1z - tvz * e1y
            qy = tvz * e1x - tvx * e1z
            qz = tvx * e1y - tvy * e1x
            v = (dx * qx + dy * qy + dz * qz) * inv_det
            t = (e2x * qx + e2y * qy + e2z * qz) * inv_det
            bt = best_t[lanes]
            ok = ((ids >= 0) & (det.abs() > 1e-12)
                  & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0)
                  & (t > t_min[lanes][:, None]) & (t < bt[:, None]))
            tc = torch.where(ok, t, INF)
            t_best = tc.min(dim=1).values
            first = torch.where(ok & (tc == t_best[:, None]), slot_index, ls)
            slot = first.min(dim=1).values
            improved = slot < ls
            slot = slot.clamp_max(ls - 1)[:, None]
            take = lambda a: torch.gather(a, 1, slot)[:, 0]
            hit_lanes = lanes[improved]
            best_t[hit_lanes] = take(t)[improved]
            best_prim[hit_lanes] = take(ids)[improved]
            best_u[hit_lanes] = take(u)[improved]
            best_v[hit_lanes] = take(v)[improved]
            if any_hit:
                finished[at_leaf[improved]] = True

        cur = torch.where(box_hit & ~is_leaf, cur + 1, miss)
        keep = (cur >= 0) & ~finished
        live, cur = live[keep], cur[keep]

    best_t = torch.where(best_prim >= 0, best_t, INF)
    return best_t, best_prim, best_u, best_v


def flat_limit(x, shape, device) -> torch.Tensor:
    """A ray limit (a float, or a tensor broadcastable to the rays' leading
    dims `shape`) as a contiguous (R,) float32 tensor on `device`."""
    if not torch.is_tensor(x):
        return torch.full((shape.numel(),), float(x), dtype=torch.float32, device=device)
    x = x.to(device=device, dtype=torch.float32)
    return torch.broadcast_to(x, shape).reshape(-1).contiguous()


def select_kernel(bvh, any_hit: bool = False, *, wide: bool = True,
                  ordered: bool = False, dual: bool = False, steady_drain: int = 3,
                  row_cursors: int = 8, q32: bool = False, stats: bool = False,
                  leaf_queue: int = 0, multi: int = 1, ray_shape=()) -> str:
    """The kernel (a name in KERNELS) that `traverse` launches for these
    options: the rule of the JAX package's `traverse_packet_pallas` / `_run`
    (``ops/pallas/traversal.py:2546-2669``, ``:2763-2802``), branch by
    branch. Where that rule tests a Mosaic capacity, the Hopper kernel's own
    limit takes its place: RC_SCAP and the 64k-node `ptr << 16` packing
    become K1's stack (`k1_stack_need(wide_depth) <= K1_STACK_CAP`; K1 has
    no node-count limit) and K1q's (`q32_depth + 1 <= K1Q_STACK_CAP`). A
    tree they cannot take goes on down the rule (q32 to the width-16 row
    kernel, that to K2), as in the JAX package; nothing here raises for a
    tree. The VMEM budgets of `_pallas_mode` and its XLA fallback have no
    counterpart: on CUDA a kernel always runs. `any_hit` does not enter
    the rule (`make_any_hit` sets `dual` instead).

    After the row path the order is the JAX one: `multi` rays per thread
    (`multi_rays` of the front's `ray_shape`, the rays' leading dims; a
    wide walk neither ordered nor with stats) take K3-multi, whatever
    `dual` and `steady_drain` say; then a steady drain takes K2; then
    `leaf_queue` takes K3-lq; then `dual`; then K3 wide or wide-ordered.
    """
    del any_hit
    if not wide:
        if stats:
            raise ValueError("the binary walks have no stats output")
        return "k3_binary_ordered" if ordered else "k3_binary"
    if row_cursors and q32 and not stats:
        if (bvh.wnode_q32 is not None and bvh.wnode_meta32 is not None
                and bvh.q32_leaf_perm is not None
                and bvh.q32_depth + 1 <= K1Q_STACK_CAP):
            return "k1q"
    if row_cursors and not stats and bvh.wnode_meta is not None \
            and k1_stack_need(bvh.wide_depth) <= K1_STACK_CAP:
        return "k1"
    if not ordered and not stats and multi_rays(ray_shape, multi) > 1:
        return "k3_wide_multi"
    if steady_drain > 0 and not ordered:
        return "k2_sdd" if dual else "k2_sd"
    if leaf_queue > 0 and not ordered:
        return "k3_wide_lq"
    if dual and not ordered:
        return "k3_wide_dual"
    return "k3_wide_ordered" if ordered else "k3_wide"


def _launch(kernel: str, bvh, o, d, tmin, tmax, any_hit: bool, steady_drain: int,
            drain_first: bool, stats: bool, leaf_queue: int, m: int,
            phase_stats: bool = False):
    """Launch `kernel` (a select_kernel name) on CUDA tensors; `m` is
    K3-multi's rays per thread; `phase_stats` takes K1's stats form."""
    wide_args = (bvh.wnode_packed, bvh.leaf_packed, bvh.wide_depth, o, d, tmin, tmax,
                 any_hit)
    if kernel == "k1":
        return traverse_wide_cuda(*wide_args, stats=phase_stats)
    if kernel == "k1q":
        return traverse_q32_cuda(bvh.wnode_q32, bvh.wnode_meta32, bvh.q32_leaf_perm,
                                 bvh.leaf_packed, bvh.q32_depth, o, d, tmin, tmax,
                                 any_hit)
    if kernel in ("k2_sd", "k2_sdd"):
        dual = kernel == "k2_sdd"
        return traverse_drain_cuda(*wide_args, drain=steady_drain, dual=dual,
                                   drain_first=drain_first and dual, stats=stats)
    if kernel.startswith("k3_binary"):
        return traverse_binary_cuda(bvh.node_packed, bvh.leaf_packed, bvh.max_depth,
                                    o, d, tmin, tmax, any_hit,
                                    ordered=kernel == "k3_binary_ordered")
    if kernel == "k3_wide_lq":
        return traverse_lq_cuda(*wide_args, flush_k=leaf_queue, stats=stats)
    if kernel == "k3_wide_multi":
        return traverse_multi_cuda(*wide_args, m=m)
    return traverse_wide_k3_cuda(*wide_args, ordered=kernel == "k3_wide_ordered",
                                 dual=kernel == "k3_wide_dual", stats=stats)


def traverse(bvh, origin, direction, t_min=1e-3, t_max=1e4, any_hit: bool = False,
             *, wide: bool = True, ordered: bool = False, dual: bool = False,
             steady_drain: int = 3, drain_first: bool = False, row_cursors: int = 8,
             q32: bool = False, stats: bool = False, leaf_queue: int = 0, multi: int = 1,
             overflow_stats: bool = False, phase_stats: bool = False):
    """Closest-hit (or any-hit) traversal of rays (..., 3) over `bvh`.

    t_min / t_max: floats or tensors broadcastable to the ray shape. The
    keyword options choose the kernel (`select_kernel`); their defaults are
    those of the JAX package's hit queries (`row_cursors=8`,
    `steady_drain=3`), which launch K1; as in the JAX package,
    `traverse(..., row_cursors=0, steady_drain=0, leaf_queue=k)` reaches
    K3-lq and `traverse(..., row_cursors=0, multi=m)` K3-multi.
    `drain_first` applies to K2's dual form. Returns (t, prim, u, v) shaped
    like the rays' leading dims; with `stats`, a fifth tensor (k, ...) int32
    of the kernel's per-ray counters (see `traverse_wide_k3_cuda`,
    `traverse_lq_cuda`, `traverse_drain_cuda`). CPU tensors take the plain
    walk, whatever the options, and have no stats; CUDA tensors launch the
    selected kernel.

    K1's two diagnostic outputs (the JAX row kernel's, which return a fifth
    value that is None where another kernel ran) take no part in the
    choice of kernel:
    - `overflow_stats` is accepted for the JAX signature and otherwise
      ignored: the fifth value is None (unless `stats` gives one). The JAX
      kernel counts the pushes its fixed per-cursor stacks and queues
      clamped; K1 never clamps, because `select_kernel` sends a tree its
      stack cannot hold to K2.
    - `phase_stats`: where K1 runs, the fifth value is K1's per-ray counts
      of its own walk, (6, ...) int32 (`traverse_wide_cuda`): iterations,
      entries expanded, leaf rows tested, pops culled by the best hit,
      child-box slab tests and triangle tests. The JAX rows count TPU phases
      per 1024-ray block (iterations, live drain and expand pops,
      all-stacks-empty and all-queues-empty iterations), which have no
      meaning on Hopper; its iterations are row 0 here. Elsewhere None.
      The plain walk on CPU tensors has none, and raises as `stats` does.
      It is not asked together with `stats`.
    """
    if stats and phase_stats:
        raise ValueError("traverse returns one diagnostic output at a time: ask for stats "
                         "or phase_stats")
    shape = origin.shape[:-1]
    kernel = select_kernel(bvh, any_hit, wide=wide, ordered=ordered, dual=dual,
                           steady_drain=steady_drain, row_cursors=row_cursors,
                           q32=q32, stats=stats, leaf_queue=leaf_queue, multi=multi,
                           ray_shape=shape)
    dev = origin.device
    o = origin.reshape(-1, 3).to(torch.float32).contiguous()
    d = direction.reshape(-1, 3).to(torch.float32).contiguous()
    tmin, tmax = flat_limit(t_min, shape, dev), flat_limit(t_max, shape, dev)
    if dev.type == "cpu":
        if stats or phase_stats:
            raise ValueError("stats count a kernel's schedule; the plain walk on "
                             "CPU tensors has none")
        out = traverse_plain(bvh.node_packed, bvh.leaf_packed, o, d, tmin, tmax,
                             any_hit)
    elif dev.type == "cuda":
        out = _launch(kernel, bvh, o, d, tmin, tmax, any_hit, steady_drain,
                      drain_first, stats, leaf_queue, multi_rays(shape, multi),
                      phase_stats=phase_stats and kernel == "k1")
    else:
        raise ValueError(f"no traversal for device {dev}")
    hits = tuple(x.reshape(shape) for x in out[:4])
    if stats or (phase_stats and len(out) > 4):
        return (*hits, out[4].reshape(-1, *shape))
    if overflow_stats or phase_stats:
        return (*hits, None)
    return hits
