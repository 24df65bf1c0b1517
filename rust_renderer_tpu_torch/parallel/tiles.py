"""Row bands of the image over a torch.distributed process group.

One process per rank. Rank r of n owns the image rows [r * band, (r + 1) *
band) with band = H / n, and the whole scene, BVH tables and view. Pixel
coordinates, RNG seeds and the camera mapping are the image's
(`row_offset = r * band`, `full_size = (H, W)`), so the rows of an n-rank
frame are the rows of the one-rank frame. The collectives are
`torch.distributed` calls on the caller's group (the world group by
default), over the backend its creator chose: this module never switches
backend or device.

`render_tiled` runs the plain path tracer on this rank's band. Nothing
crosses ranks during the frame but the active-ray count; `gather_rows`
assembles a whole image where a caller wants one. `spawn_ranks` runs a
function on n ranks of one machine without torchrun.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from rust_renderer_tpu_torch.ops import pathtrace
from rust_renderer_tpu_torch.utils import require_port_values

# Bytes that gather_rows has assembled in this process (the whole gathered
# tensors'), for the caller to read and zero like the kernels' counters.
GATHERED_BYTES = 0
# How long a spawn_ranks rank waits in a collective before it raises: a rank
# that never arrives is a fault to surface, not to wait out.
RANK_TIMEOUT = datetime.timedelta(minutes=10)


def group_rank(group=None) -> tuple[int, int]:
    """(this rank's index in `group`, the group's size); the world group by
    default."""
    return dist.get_rank(group), dist.get_world_size(group)


def gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's `t` stacked along dim 0 in rank order: the whole image
    of a row-banded tensor."""
    global GATHERED_BYTES
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    GATHERED_BYTES += t.nbytes * len(parts)
    return torch.cat(parts)


def band_rows(height: int, n: int) -> int:
    """Rows per band of an image `height` rows high over `n` ranks."""
    if height % n:
        raise ValueError(f"height {height} not divisible by {n} ranks")
    return height // n


def shard_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's band of a whole-image tensor (H, ...)."""
    index, n = group_rank(group)
    rows = band_rows(t.shape[0], n)
    return t[index * rows:(index + 1) * rows]


@dataclasses.dataclass(frozen=True)
class RowBand:
    """This rank's band of an image of `full_height` rows (and `width`
    columns, where known) split over `group`."""

    group: object
    index: int
    count: int
    full_height: int
    width: int | None = None

    @staticmethod
    def of(group, height: int, width: int | None = None) -> "RowBand":
        index, n = group_rank(group)
        band_rows(height, n)
        return RowBand(group, index, n, int(height), None if width is None else int(width))

    @property
    def rows(self) -> int:
        return self.full_height // self.count

    @property
    def offset(self) -> int:
        return self.index * self.rows

    def gather(self, t: torch.Tensor) -> torch.Tensor:
        return gather_rows(t, self.group)


def make_tile_group(n_ranks: int | None = None, backend: str | None = None,
                    device="cuda"):
    """The group that the image's row bands split over, and this rank's band
    index in it (the counterpart of the JAX package's `make_tile_mesh`).

    Where the default group is not initialized yet it is, from the
    environment that `torchrun` sets (env://), with `backend` (default: nccl
    on "cuda", gloo on "cpu"). The group is the first `n_ranks` ranks of
    the world (all of them by default), over `backend` where it differs
    from the world's; every rank must call this, and a rank outside the
    group gets (None, None). On "cuda" this rank's current device becomes
    LOCAL_RANK modulo the cards (ranks share a card where they outnumber
    them); without a GPU, "cuda" raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' requested but torch sees no GPU")
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(backend, init_method="env://")
    world = dist.get_world_size()
    n = world if n_ranks is None else int(n_ranks)
    if not 1 <= n <= world:
        raise ValueError(f"n_ranks {n} outside 1..{world}")
    if n == world and backend == dist.get_backend():
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)), backend=backend)
    if dist.get_rank() >= n:
        return None, None
    return group, dist.get_rank(group)


def check_axis(where: str, axis: str) -> None:
    """The JAX mesh's axis name: a group has no axes, and the bands split
    the rows, the JAX default axis "tiles"."""
    require_port_values(where, "a torch.distributed group has no named axes; the bands "
                        "split the rows", axis=(axis, "tiles"))


def render_tiled(scene, view, cfg, accumulation: torch.Tensor, group=None,
                 reservoirs=None, closest_hit=None, axis: str = "tiles"
                 ) -> pathtrace.PathTraceResult:
    """This rank's band of one path-traced frame (the JAX package's
    `render_tiled`). accumulation: this rank's (H / n, W, 3) band;
    reservoirs: its band of the spatial planes, or None. Returns the band's
    PathTraceResult; rays_traced is summed over the group."""
    check_axis("render_tiled", axis)
    index, n = group_rank(group)
    rows, width = accumulation.shape[:2]
    kwargs = {} if closest_hit is None else {"closest_hit": closest_hit}
    res = pathtrace.path_trace(scene, view, cfg, accumulation, reservoirs=reservoirs,
                               row_offset=index * rows, full_size=(rows * n, width), **kwargs)
    rays = res.rays_traced.clone()
    dist.all_reduce(rays, group=group)
    return res._replace(rays_traced=rays)


def _rank_entry(rank, fn, n, workdir, threads, args):
    if threads is not None:
        torch.set_num_threads(threads)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/store", rank=rank,
                            world_size=n, timeout=RANK_TIMEOUT)
    try:
        torch.save(fn(rank, n, *args), f"{workdir}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, n: int, workdir: str, args=(), threads: int | None = None) -> list:
    """fn(rank, n, *args) on n new processes whose default group is the n
    ranks over gloo (which also carries CUDA tensors, so ranks can share one
    card, where NCCL refuses two ranks on a device), initialized through a file store in `workdir` (an
    empty directory: no network port is opened); `threads` sets each
    rank's torch CPU threads. Returns the ranks' results, saved by
    torch.save, in rank order; a rank that raises, or waits in a
    collective longer than RANK_TIMEOUT, ends the others and raises here.
    fn must be importable by name (a module-level function)."""
    mp.spawn(_rank_entry, args=(fn, n, workdir, threads, args), nprocs=n, join=True)
    return [torch.load(f"{workdir}/rank{r}.pt", weights_only=False) for r in range(n)]
