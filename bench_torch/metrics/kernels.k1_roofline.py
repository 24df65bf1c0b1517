"""kernels.k1_roofline: K1's share of its memory bound (%), the least
time over K1's device time in the traced window.

The least time is the bytes the walks need at the card's HBM rate: each
live ray of a launch read once (origin, direction, t_min: 28 B), each
result written once (t, prim, u, v: 16 B closest hit; prim: 4 B any hit),
and the scene's triangles (3 vertices: 36 B) once a launch. Live rays are
counted by the harness's wrapper of the traversal entry (a ray whose
direction is not zero; lanes a static front has retired do not count),
replays included; launches are the trace's K1 records. The count reads
the rays and the scene, not the kernel's layouts, padding or tree, so it
is the same whatever walks them. Operations are not counted: this is the
memory bound. Peak: 3.35 TB/s (H100 SXM data sheet, at 700 W)."""

from harness.trace import base_name

HBM_BYTES_PER_S = 3.35e12
RAY_BYTES, CLOSEST_BYTES, ANY_HIT_BYTES, TRIANGLE_BYTES = 28, 16, 4, 36

KERNEL = "k1_traverse_wide_kernel"


def is_k1(name: str) -> bool:
    return base_name(name) == KERNEL


def least_bytes(closest_rays: int, any_hit_rays: int, launches: int, triangles: int) -> int:
    return (closest_rays * (RAY_BYTES + CLOSEST_BYTES)
            + any_hit_rays * (RAY_BYTES + ANY_HIT_BYTES)
            + launches * triangles * TRIANGLE_BYTES)


def read(r):
    if r.trace is None or r.rays is None:
        return None
    seconds = r.trace.kernel_s(is_k1)
    launches = r.trace.count(is_k1)
    if seconds <= 0 or launches == 0:
        return None
    closest, any_hit = r.rays
    least = least_bytes(closest, any_hit, launches, r.config["scene_triangles"]) / HBM_BYTES_PER_S
    return 100.0 * least / seconds
