"""kernels.k4_roofline: K4's share of its memory bound (%), the least time
over K4's device time in the traced window. A launch rasterizes one
cascade: the scene's triangles read once (36 B each) and the cascade's
depth map written once (shadow_map_size squared x 4 B); launches are the
trace's K4 records. Peak: 3.35 TB/s (H100 SXM data sheet, at 700 W)."""

from harness.trace import base_name

HBM_BYTES_PER_S = 3.35e12
TRIANGLE_BYTES, DEPTH_BYTES = 36, 4

KERNEL = "k4_depth_kernel"


def is_k4(name: str) -> bool:
    return base_name(name) == KERNEL


def least_bytes(launches: int, triangles: int, map_size: int) -> int:
    return launches * (triangles * TRIANGLE_BYTES + map_size * map_size * DEPTH_BYTES)


def read(r):
    if r.trace is None:
        return None
    seconds = r.trace.kernel_s(is_k4)
    launches = r.trace.count(is_k4)
    if seconds <= 0 or launches == 0:
        return None
    size = r.config["static_config"]["shadow_map_size"]
    least = least_bytes(launches, r.config["scene_triangles"], size) / HBM_BYTES_PER_S
    return 100.0 * least / seconds
