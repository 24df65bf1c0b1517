"""kernels.sky_ms: the device time of the sky kernel (`sky_scatter_kernel`,
the atmosphere's scattering integral of csrc/atmosphere.cu) in the traced
window, divided by its frames. A program without the kernel reads None."""

from harness.trace import base_name

KERNEL = "sky_scatter_kernel"


def is_sky(name: str) -> bool:
    return base_name(name) == KERNEL


def read(r):
    if r.trace is None:
        return None
    s = r.trace.kernel_s(is_sky)
    return s * 1000.0 / r.trace.frames if s > 0 else None
