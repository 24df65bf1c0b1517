"""Native code of the port: build at first use, bind with ctypes, launch.

Each native library is declared, by the module that calls it, with
`declare`: its name, its sources, the headers they include (`deps`) and
each exported function's ctypes argument types. The sources are

- the CUDA kernels under ``rust_renderer_tpu_torch/csrc/``, compiled with
  nvcc (`nvcc_command`); each op module declares the libraries it launches
  and launches them through `Library.launch`;
- the binned-SAH BVH builder, compiled with g++ from the JAX package's
  ``rust_renderer_tpu/native/bvh_builder.cpp`` (read as a C++ source by path,
  so the port's tables are the SAH tables the JAX package builds).

They are built into the git-ignored ``rust_renderer_tpu_torch/build/``
directory. A library's file is named by the hash of its sources, headers
and build command, so a changed source builds a new file; `invalidate`
drops the binding of every library built from a changed file (a hot
reload), and the next launch loads the new code: the dynamic loader would
hand back the old handle for an unchanged path. A failed build raises: the
port has no silent fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import shutil
import subprocess

import numpy as np
import torch

log = logging.getLogger(__name__)

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_DIR = os.path.dirname(PACKAGE_DIR)
BUILD_DIR = os.path.join(PACKAGE_DIR, "build")
CSRC = os.path.join(PACKAGE_DIR, "csrc")
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


class Library:
    """A declared native library (`declare`). `library()` builds and binds
    it at its first use and returns the cached binding after that."""

    def __init__(self, name: str, sources: list[str], functions: dict[str, list],
                 deps: tuple[str, ...], command: list[str] | None):
        self.name = name
        self.sources = [os.path.join(CSRC, src) for src in sources]
        self.deps = tuple(os.path.join(CSRC, dep) for dep in deps)
        self.functions = functions
        self.command = command
        self._lib: ctypes.CDLL | None = None

    def library(self) -> ctypes.CDLL:
        lib = self._lib
        if lib is None:
            # nvcc is resolved on PATH here, once per binding, not per launch.
            lib = load_library(self.name, self.sources, self.command or nvcc_command(),
                               deps=self.deps)
            for fn_name, argtypes in self.functions.items():
                fn = getattr(lib, fn_name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            self._lib = lib
        return lib

    def launch(self, fn: str, what: str, device, *args) -> None:
        """Call the exported function `fn` with `args` and then the current
        stream of `device`; raises `RuntimeError("<what> launch failed:
        cudaError <n>")` on a nonzero return."""
        err = getattr(self.library(), fn)(*args, torch.cuda.current_stream(device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"{what} launch failed: cudaError {err}")


# Every declared library, by name. A module that is reloaded declares its
# libraries again, and the new declaration takes the name.
LIBRARIES: dict[str, Library] = {}


def declare(name: str, sources: list[str], functions: dict[str, list],
            deps: tuple[str, ...] = (), command: list[str] | None = None) -> Library:
    """Declare the library `name`, built from `sources` (file names under
    csrc/, or paths) with `command` (default `nvcc_command()`), its hash
    covering the headers `deps` that they include; `functions` maps each
    exported function to its ctypes argument types (each returns an int
    status). Returns the Library the caller launches through."""
    lib = Library(name, sources, functions, tuple(deps), command)
    LIBRARIES[name] = lib
    return lib


def invalidate(path: str) -> list[str]:
    """Drop the binding of every declared library that `path` (a source or
    a header) is built into, so that its next launch loads the library of
    the files as they stand. Returns those libraries' names."""
    path = os.path.realpath(path)
    names = []
    for lib in LIBRARIES.values():
        if path in {os.path.realpath(f) for f in (*lib.sources, *lib.deps)}:
            lib._lib = None
            names.append(lib.name)
    return names


def check(name: str, x: torch.Tensor, dtype, shape, device) -> None:
    """Raises unless `x` is a contiguous tensor of `dtype` and `shape` on
    `device`, as a kernel reads it."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} has dtype {x.dtype}, expected {dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {tuple(shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} is not contiguous")


BVH_BUILDER = declare("bvh_builder", [BVH_BUILDER_SRC], {"bvh_build_sah": [
    ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
    ctypes.POINTER(ctypes.c_int32), ctypes.c_int32, ctypes.c_int32,
    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
]}, command=["g++", "-O3", "-shared", "-fPIC"])


def have_native() -> bool:
    """Whether the native BVH builder builds and loads here (g++ and the
    JAX package's source are there). The port has no other builder, so
    `ops/bvh.py::build_bvh` raises where this is False."""
    try:
        BVH_BUILDER.library()
    except (OSError, RuntimeError, subprocess.SubprocessError):
        log.exception("native bvh_builder unavailable")
        return False
    return True


def build_bvh_sah(positions: np.ndarray, indices: np.ndarray, leaf_size: int):
    """Binned-SAH build over (V,3) f32 positions and (T,3) i32 indices, T > 0.
    Returns (node_min, node_max, node_miss, node_leaf, leaf_tris)."""
    lib = BVH_BUILDER.library()
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
