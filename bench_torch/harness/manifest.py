"""The cells, found by name. `BENCHMARK.json` at the root of the checkout
names each cell's configuration and traffic mix; every piece is a file of
its own under ``bench_torch/``, so a later change adds a configuration, a
mix, a limit file or a per-layer metric as new files and new entries, and
edits none:

- ``configs/<config>.json``: the scene builder, mode, size, StaticConfig
  and view overrides (its `file` in BENCHMARK.json);
- ``traffic/<mix>.json``: the loop and its parameters;
- ``limits/<config>.<mix>.json``: the limit of each number the check
  compares;
- ``metrics/<metric>.py``: one reader per per-layer metric, a function
  `read(readings)` that returns the value or None.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list


def _load_json(path: str) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, bench_dir: str = BENCH_DIR) -> Cell:
    """The cell `name` of `root`/BENCHMARK.json with its files."""
    manifest = _load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _load_json(os.path.join(root, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(bench_dir, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(bench_dir, "limits", f"{name}.json"))
    return Cell(
        name=name, chips=int(w["chips"]), config_name=w["config"], config=config,
        traffic_name=w["traffic"], traffic=traffic, limits=limits,
        end_to_end=[m for m in manifest["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in manifest["per_layer"] if _reports(m, name)],
    )


def load_reader(metric: str, bench_dir: str = BENCH_DIR):
    """The `read` function of ``metrics/<metric>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
