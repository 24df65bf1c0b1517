"""The benchmark of rust_renderer_tpu_torch on NVIDIA GPUs; see
harness/cli.py.

    python3 bench_torch/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from harness import cli

    raise SystemExit(cli.main())
