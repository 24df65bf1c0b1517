"""run.py exits nonzero and prints no result where it finds no card, and
where the checkout holds only the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from harness import manifest


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, "bench_torch/run.py", "--workload", "raster_rtshadows_sponza_1080p.still",
         "--seed", str(2 ** 32 + 5), "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_run_fails_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    _no_result(_run(manifest.ROOT))


def test_run_fails_with_only_the_benchmarks_files(tmp_path):
    shutil.copy(os.path.join(manifest.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(manifest.BENCH_DIR, tmp_path / "bench_torch",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    _no_result(_run(str(tmp_path)))
