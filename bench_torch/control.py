"""The control of the check, on the card: for each seed, one run of a cell
(a short window that reaches the units the check draws), the program's
compared numbers, and beside them each control's, where the reference
itself stands in for the program one precision below the configuration's
(TF32 matmuls, or every pass's float32 outputs stored in bfloat16). The
limits in limits/<cell>.json are set between the program's numbers over
a dozen seeds and the controls'. Prints one JSON line a seed.

    python3 bench_torch/control.py --workload <cell> --seeds 11,12,13 [--seconds 3]
"""

import argparse
import json
import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from harness import cli, manifest

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--controls", default="tf32,bf16")
    args = p.parse_args()
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the control runs on the card")
    sys.path.append(manifest.ROOT)
    cell = manifest.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = cli.run(cell, seed, args.seconds, False, "cuda",
                      controls=tuple(args.controls.split(",")))
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": res["correct"],
                          "program": {k: c["value"] for k, c in res["checks"].items()},
                          "controls": res["controls"]}), flush=True)
