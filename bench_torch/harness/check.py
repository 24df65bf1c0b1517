"""The check that decides `correct`: the units the window drew from the
seed, recomputed by the plain reference (``bench_torch/rrt_reference``).

The configuration names the reference module that renders its frames
(its `reference` key); the module's `Reference(config, device, size)`
builds its own scene, tree and environment. The check replays the run's
host side unit by unit on it (the input path and the camera, with no
frame rendered) up to each checked unit, renders that unit from the
persistent state the program's unit started from (teacher forcing, as a
served model's tokens are fed back; a frame without such state takes
none), and compares what it presents, and any persistent state the unit
left, with the program's.

A control stands in for the program where asked: the reference itself
one precision below float32 with TF32 off, by its `lower_precision`:
"tf32" (TF32 matmuls) or "bf16" (every pass's outputs kept in bfloat16)."""

from __future__ import annotations

import importlib

import numpy as np

from harness import traffic


def outputs(image, state: dict) -> dict:
    """What the check compares of a unit: its presented image, and the
    persistent state it left (by the state's names)."""
    out = {"image": np.asarray(image, np.float32)}
    out.update({k: v.float().cpu().numpy() for k, v in state.items()})
    return out


def reference(cell, seed: int, checked: list, device, size=None,
              control: str | None = None) -> list[dict]:
    """The reference's outputs of each checked unit (in `checked`'s order)."""
    module = importlib.import_module(cell.config["reference"])
    ref = module.Reference(cell.config, device, size)
    t = cell.traffic
    host_loop = t["loop"] == "host"
    path = (traffic.orbit_inputs(t, cell.config["viewpoint"], cell.config["target"])
            if host_loop else None)
    mouse = [0.0, 0.0]
    by_unit = {c.unit: c for c in checked}
    results = {}
    # Unit -1 is the warm-up: a host frame with no input, or one call.
    for u in range(-1, max(by_unit, default=-1) + 1):
        if host_loop:
            ref.input.begin_frame()
            if u >= 0:
                traffic.apply_input(ref.input, next(path), mouse)
            ref.step_camera()
        if u in by_unit:
            with ref.lower_precision(control):
                results[u] = ref.render(by_unit[u].before)
    return [results[c.unit] for c in checked]


def image_gap(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(the share of pixels whose worst channel is off by more than 1e-3
    of max(1, |reference|), the mean absolute gap over the mean absolute
    reference); a non-finite value counts as off."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return 1.0, float("inf")
    gap = np.abs(got - want)
    gap[~np.isfinite(gap)] = np.inf
    tol = 1e-3 * np.maximum(1.0, np.abs(want))
    off = (gap > tol).reshape(-1, want.shape[-1] if want.ndim == 3 else 1).any(axis=1)
    mean = gap.mean() / max(np.abs(want).mean(), 1e-30)
    return float(off.mean()), float(mean)


def readings(got: list[dict], want: list[dict]) -> dict:
    """The numbers compared, each the worst over the checked units: of an
    image or a plane, `<name>_off` and `<name>_gap` (see image_gap); of a
    count, `<name>_gap`, its gap over the reference's count."""
    out: dict[str, float] = {}

    def worst(name, value):
        out[name] = max(out.get(name, 0.0), value)

    for g, w in zip(got, want):
        for name, ref in w.items():
            mine = g.get(name)
            if np.ndim(ref) >= 2:
                off, mean = image_gap(mine if mine is not None else np.zeros(0), ref)
                worst(f"{name}_off", off)
                worst(f"{name}_gap", mean)
            else:
                gap = (abs(float(mine) - float(ref)) / max(abs(float(ref)), 1.0)
                       if mine is not None and np.isfinite(mine) else float("inf"))
                worst(f"{name}_gap", gap)
    return out


def judge(values: dict, limits: dict, failed: int, missing: int) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}): no frame failed, no drawn
    unit left unchecked, and every number compared at or under its limit."""
    checks = {"failed_frames": {"value": failed, "limit": 0},
              "units_unchecked": {"value": missing, "limit": 0}}
    for name in sorted(values):
        if name not in limits:
            raise KeyError(f"no limit for the compared number {name!r}")
        checks[name] = {"value": values[name], "limit": limits[name]}
    ok = all(bool(c["value"] <= c["limit"]) for c in checks.values())
    return ok, checks
