"""kernels.k4_ms: the device time of K4 (`k4_depth_kernel`, the binned
depth rasterizer of csrc/raster_binned.cu, one launch a shadow cascade) in
the traced window, divided by its frames."""

from harness.trace import base_name

KERNEL = "k4_depth_kernel"


def is_k4(name: str) -> bool:
    return base_name(name) == KERNEL


def read(r):
    if r.trace is None:
        return None
    s = r.trace.kernel_s(is_k4)
    return s * 1000.0 / r.trace.frames if s > 0 else None
