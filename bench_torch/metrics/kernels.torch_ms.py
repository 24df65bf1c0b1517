"""kernels.torch_ms: the device time of every kernel that is not the
program's own (a `__global__` function under rust_renderer_tpu_torch/csrc/
or a Triton kernel of the package): PyTorch's kernels for the eager code,
divided by the traced frames. The harness's own few kernels a frame in a
traced run (see graph.kernels_per_frame) are PyTorch's and count here, at
a few microseconds a frame."""

from harness.trace import base_name


def read(r):
    if r.trace is None or not r.trace.kernels:
        return None
    return r.trace.kernel_s(lambda n: base_name(n) not in r.port_kernels) \
        * 1000.0 / r.trace.frames
