"""kernels.ssao_ms: the device time of the SSAO kernels (`ssao_depth_kernel`
and `ssao_occlusion_kernel`, the SSAO pass's view-depth plane and occlusion
of csrc/ssao.cu) in the traced window, divided by its frames. A program
without the kernels reads None."""

from harness.trace import base_name

KERNELS = ("ssao_depth_kernel", "ssao_occlusion_kernel")


def is_ssao(name: str) -> bool:
    return base_name(name) in KERNELS


def read(r):
    if r.trace is None:
        return None
    s = r.trace.kernel_s(is_ssao)
    return s * 1000.0 / r.trace.frames if s > 0 else None
