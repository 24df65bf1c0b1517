"""Native code of the port: build at first use, bind with ctypes.

Two libraries are built from the checkout's sources into the git-ignored
``rust_renderer_tpu_torch/build/`` directory:

- the binned-SAH BVH builder, compiled with g++ from the JAX package's
  ``rust_renderer_tpu/native/bvh_builder.cpp`` (read as a C++ source by path,
  so the port's tables are the SAH tables the JAX package builds);
- the CUDA kernels under ``rust_renderer_tpu_torch/csrc/``, compiled with
  nvcc (see ``ops/traversal.py``).

A library's file is named by the hash of its sources and build command,
so a changed source builds a new file and a process that loads the library
again (a hot reload) loads the new code: the dynamic loader would hand back
the old handle for an unchanged path. A failed build raises: the port has no
silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess

import numpy as np

log = logging.getLogger(__name__)

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
BVH_BUILDER_SRC = os.path.join(REPO_DIR, "rust_renderer_tpu", "native",
                               "bvh_builder.cpp")

_loaded: dict[str, ctypes.CDLL] = {}  # by the library's path


def build_library(name: str, sources: list[str], command: list[str],
                  timeout: float = 600.0, deps: tuple[str, ...] = ()) -> str:
    """Compile `sources` into BUILD_DIR/lib<name>-<hash>.so, the hash that of
    the sources, headers (`deps`) and command, unless that file is there.
    `command` is the compiler invocation without the output flag and
    sources. The compiler's report of the last build goes to
    BUILD_DIR/lib<name>.so.log. Returns the path."""
    digest = hashlib.sha256(" ".join(command).encode())
    for src in [*sources, *deps]:
        with open(src, "rb") as f:
            digest.update(f.read())
    lib_path = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")
    if os.path.exists(lib_path):
        return lib_path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # Build under a private name and rename: concurrent test workers may
    # build the same library at once.
    tmp = f"{lib_path}.{os.getpid()}.tmp"
    proc = subprocess.run(command + ["-o", tmp] + sources,
                          capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building lib{name}.so failed ({' '.join(command)}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    # The compiler's report (nvcc -Xptxas=-v: registers, spills) for reading.
    with open(f"{tmp}.log", "w") as f:
        f.write(proc.stdout + proc.stderr)
    os.replace(f"{tmp}.log", os.path.join(BUILD_DIR, f"lib{name}.so.log"))
    os.replace(tmp, lib_path)
    return lib_path


def load_library(name: str, sources: list[str], command: list[str],
                 deps: tuple[str, ...] = ()) -> ctypes.CDLL:
    """build_library + ctypes load, once per process for each version of the
    sources."""
    path = build_library(name, sources, command, deps=deps)
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(path)
    return _loaded[path]


def _bvh_lib() -> ctypes.CDLL:
    lib = load_library("bvh_builder", [BVH_BUILDER_SRC],
                       ["g++", "-O3", "-shared", "-fPIC"])
    fn = lib.bvh_build_sah
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
    return lib


def have_native() -> bool:
    """Whether the native BVH builder builds and loads here (g++ and the
    JAX package's source are there). The port has no other builder, so
    `ops/bvh.py::build_bvh` raises where this is False."""
    try:
        _bvh_lib()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        log.exception("native bvh_builder unavailable")
        return False
    return True


def build_bvh_sah(positions: np.ndarray, indices: np.ndarray, leaf_size: int):
    """Binned-SAH build over (V,3) f32 positions and (T,3) i32 indices, T > 0.
    Returns (node_min, node_max, node_miss, node_leaf, leaf_tris)."""
    lib = _bvh_lib()
    positions = np.ascontiguousarray(positions, np.float32)
    indices = np.ascontiguousarray(indices, np.int32)
    t = len(indices)
    if t == 0:
        raise ValueError("build_bvh_sah needs at least one triangle")
    cap = 2 * t
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    node_miss = np.empty(cap, np.int32)
    node_leaf = np.empty(cap, np.int32)
    leaf_tris = np.empty((cap, leaf_size), np.int32)
    counts = np.zeros(2, np.int32)

    fp = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    ip = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
    rc = lib.bvh_build_sah(
        fp(positions), len(positions), ip(indices), t, leaf_size,
        fp(node_min), fp(node_max), ip(node_miss), ip(node_leaf),
        ip(leaf_tris), ip(counts),
    )
    if rc != 0:
        raise RuntimeError(f"bvh_build_sah returned {rc}")
    n, l = int(counts[0]), int(counts[1])
    return (
        node_min[:n].copy(), node_max[:n].copy(), node_miss[:n].copy(),
        node_leaf[:n].copy(), leaf_tris[:l].copy(),
    )
