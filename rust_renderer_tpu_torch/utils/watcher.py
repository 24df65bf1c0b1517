"""Kernel hot-reload watcher (rebuild of utopian/src/directory_watcher.rs;
the port of the JAX package's ``utils/watcher.py``).

The reference watches `utopian/shaders/` with a 100 ms debounce and
recompiles the touched GLSL (main.rs:430-448). Here the 'shaders' are the
port's Python modules (ops, renderers) and its CUDA sources (csrc/*.cu,
*.cuh); the watcher polls their mtimes and reports a changed file.
`module_name_for` names the module that `Graph.recompile_shader` reloads
for a Python file; a CUDA source goes to `native.invalidate`, which knows
the libraries built from it.
"""

from __future__ import annotations

import os
import time

PACKAGE = "rust_renderer_tpu_torch"
WATCHED_SUFFIXES = (".py", ".cu", ".cuh")


class DirectoryWatcher:
    def __init__(self, root: str, debounce_seconds: float = 0.1):
        self.root = root
        self.debounce = debounce_seconds
        self._mtimes: dict[str, float] = {}
        self._last_event: dict[str, float] = {}
        self._scan(initial=True)

    def _scan(self, initial: bool = False) -> list[str]:
        changed = []
        now = time.time()
        for dirpath, _dirs, files in os.walk(self.root):
            for f in files:
                if not f.endswith(WATCHED_SUFFIXES):
                    continue
                path = os.path.join(dirpath, f)
                try:
                    m = os.path.getmtime(path)
                except OSError:
                    continue
                old = self._mtimes.get(path)
                self._mtimes[path] = m
                if initial or old is None or m <= old:
                    continue
                # Debounce (directory_watcher.rs:26-40).
                if now - self._last_event.get(path, 0.0) < self.debounce:
                    continue
                self._last_event[path] = now
                changed.append(path)
        return changed

    def check_if_modification(self) -> str | None:
        """Returns one modified file path, or None."""
        changed = self._scan()
        return changed[0] if changed else None

    @staticmethod
    def module_name_for(path: str) -> str | None:
        """The dotted module of a Python file inside the package; None for
        anything else."""
        path = os.path.abspath(path)
        marker = PACKAGE + os.sep
        idx = path.rfind(marker)
        if idx < 0:
            return None
        rel = path[idx:]
        if not rel.endswith(".py"):
            return None
        return rel.removesuffix(".py").replace(os.sep, ".").removesuffix(".__init__")
