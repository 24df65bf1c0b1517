"""kernels.k1_ms: the device time of K1 (`k1_traverse_wide_kernel`, the
wide-BVH walk of csrc/traverse_wide.cu) in the traced window, divided by
its frames."""

from harness.trace import base_name

KERNEL = "k1_traverse_wide_kernel"


def is_k1(name: str) -> bool:
    return base_name(name) == KERNEL


def read(r):
    if r.trace is None:
        return None
    s = r.trace.kernel_s(is_k1)
    return s * 1000.0 / r.trace.frames if s > 0 else None
