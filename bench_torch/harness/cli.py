"""One run of one cell: set-up, the measured window, the traced window
where asked, the check against the plain reference, and the result line.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with --trace 1 `breakdown`,
and last `checks`, each compared number beside its limit); the compared
numbers are also the last lines of standard error. A machine without the
cards the cell asks for gets no result and a nonzero exit."""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

from harness import manifest

# The app's PROFILER scopes, and the harness's, that name the host's part
# of an idle gap.
HOST_SCOPES = {"frame", "build_graph", "render", "frame_loop", "render_loop", "present",
               "environment_update", "create_scene", "pack_scene", "build_bvh",
               "bench.trace_window"}
CACHE_DIR = os.path.join(manifest.BENCH_DIR, ".cache")


def process_start() -> float:
    """This process's start on the `time.time()` clock (Linux), or now."""
    try:
        with open("/proc/self/stat", encoding="ascii") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat", encoding="ascii") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


class Readings:
    """What a per-layer reader reads (``metrics/<name>.py::read``)."""

    def __init__(self, cell, window, totals, trace, rays, state, port_kernels):
        self.config = cell.config
        self.traffic = cell.traffic
        self.window_frames = window.frames
        self.window_s = window.seconds  # the untraced window's length
        self.profiler_totals = totals  # scope -> (calls, host ms) over the window
        self.trace = trace  # harness.trace.Trace of the traced units, or None
        self.rays = rays  # (closest-hit, any-hit) live rays over the traced units
        self.state = state  # the frame's persistent resources after the traced units
        self.port_kernels = port_kernels  # identifiers of the program's own kernels

    @property
    def host_loop(self) -> bool:
        return self.traffic["loop"] == "host"


def run(cell, seed: int, seconds: float, trace_on: bool, device: str = "cuda",
        t_start: float | None = None, size: dict | None = None,
        units: int | None = None, controls: tuple = ()) -> dict:
    """One run; returns the result object (and, under "controls", each
    control's compared numbers)."""
    import torch

    from harness import check, session, trace as trace_mod

    t_start = time.time() if t_start is None else t_start
    program = session.Program(cell, seed, device, size, count_rays=trace_on)
    program.warm_up()
    setup_s = time.time() - t_start
    print(f"set-up {setup_s:.3f} s", file=sys.stderr)
    window = program.window(seconds, units)
    print(f"window {window.frames} frames in {window.seconds:.3f} s, "
          f"{window.attempted} attempted, {window.failed} failed", file=sys.stderr)
    if window.error:
        print(window.error, file=sys.stderr)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    totals = program.profiler.totals()
    metrics = {}
    for m in cell.end_to_end:
        # A quantity may be split by cell (frame_ms.orbit is frame_ms in
        # the orbit cells, under its own bound).
        quantity = m["name"].split(".", 1)[0]
        value = None
        if quantity == "setup_s":
            value = setup_s
        elif window.frames and quantity == "frame_ms":
            value = window.seconds * 1000.0 / window.frames
        elif window.latencies and quantity == "frame_ms_p90":
            from harness.stats import percentile
            value = percentile([x * 1000.0 for x in window.latencies], 90)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": False, "attempted": window.attempted, "failed": window.failed}
    breakdown = None
    if trace_on and not window.error:
        t_tr = time.time()
        tr, named, counts = program.traced(int(cell.traffic["trace_units"]))
        print(f"traced window {tr.window_s:.3f} s, read in {time.time() - t_tr:.3f} s",
              file=sys.stderr)
        readings = Readings(cell, window, totals, tr, counts, program.app.graph.state,
                            trace_mod.port_kernel_names(
                                os.path.join(manifest.ROOT, session.PROGRAM)))
        metrics = {}
        for m in cell.per_layer:
            value = manifest.load_reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev["busy_s"] = tr.busy_s()
        dev["window_s"] = tr.window_s
        breakdown = {"device_ops": tr.device_ops(), "idle_gaps": named.idle_gaps(HOST_SCOPES)}
    program.close()
    del program
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    drawn = session.check_units(seed, cell.traffic)
    checked = [c for c in window.checked if c.unit in drawn]
    for c in checked:  # off the device, so the reference has it to itself
        c.before = {k: v.cpu() for k, v in c.before.items()}
        c.after = {k: v.cpu() for k, v in c.after.items()}
    t_ref = time.time()
    want = check.reference(cell, seed, checked, device, size) if checked else []
    print(f"reference: units {[c.unit for c in checked]} in {time.time() - t_ref:.3f} s",
          file=sys.stderr)
    got = [check.outputs(c.image, c.after) for c in checked]
    values = check.readings(got, want)
    ok, checks = check.judge(values, cell.limits, window.failed, len(drawn) - len(checked))
    result.update(correct=ok, metrics=metrics, device=dev)
    if breakdown is not None:
        result["breakdown"] = breakdown
    if controls:
        result["controls"] = {
            kind: check.readings(check.reference(cell, seed, checked, device, size,
                                                 control=kind), want)
            for kind in controls}
    result["checks"] = checks
    return result


def print_result(result: dict) -> None:
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)


def main(argv=None) -> int:
    t_start = process_start()
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    cell = manifest.load_cell(args.workload)
    # Kernel caches at fixed paths inside the checkout: only the first run
    # of a checkout builds. The program builds its CUDA libraries into its
    # own git-ignored build/ directory.
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA device(s); torch sees {have}",
              file=sys.stderr)
        return 2
    sys.path.append(manifest.ROOT)
    result = run(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    print_result(result)
    return 0
