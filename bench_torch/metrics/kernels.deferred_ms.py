"""kernels.deferred_ms: the device time of the deferred kernel
(`deferred_shade_kernel`, the deferred pass's composite of
csrc/deferred.cu) in the traced window, divided by its frames. A program
without the kernel reads None."""

from harness.trace import base_name

KERNEL = "deferred_shade_kernel"


def is_deferred(name: str) -> bool:
    return base_name(name) == KERNEL


def read(r):
    if r.trace is None:
        return None
    s = r.trace.kernel_s(is_deferred)
    return s * 1000.0 / r.trace.frames if s > 0 else None
