"""Multi-device rendering: the image split into row bands over a
torch.distributed process group.

The reference renders on one GPU; the JAX package splits the image over a
device mesh with `shard_map`. Here each rank is one process (torchrun, or
torch.multiprocessing) that owns a contiguous band of image rows and the
whole scene; per-pixel work stays on the band, pixel coordinates and RNG
streams are the image's, and the only collectives are the ones written out:
the flagship chain's reservoir gathers (parallel/flagship.py) and, in a
row-sharded graph (`Graph.shard_image_rows`), the halos of SSAO and FXAA
and the depth under the marching-cubes draw.
"""

from rust_renderer_tpu_torch.parallel.flagship import (
    flagship_step,
    render_flagship_tiled,
    shard_flagship_inputs,
)
from rust_renderer_tpu_torch.parallel.tiles import (
    RowBand,
    gather_rows,
    make_tile_group,
    render_tiled,
    spawn_ranks,
)

__all__ = [
    "RowBand",
    "flagship_step",
    "gather_rows",
    "make_tile_group",
    "render_flagship_tiled",
    "render_tiled",
    "shard_flagship_inputs",
    "spawn_ranks",
]
