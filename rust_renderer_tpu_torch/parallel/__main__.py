"""Render frames with the image split into row bands, one process a rank.

    torchrun --nproc_per_node=4 -m rust_renderer_tpu_torch.parallel \\
        --width 1920 --height 1080 --frames 8 --mode pt --out frame.png

Each rank renders its band of every frame through the app's graph
(`Graph.shard_image_rows`); rank 0 writes the gathered last frame. On
the GPU the ranks talk over NCCL, one card a rank (LOCAL_RANK); with
`--device cpu`, over gloo. The height must divide by the number of ranks.
"""

from __future__ import annotations

import argparse

import torch.distributed as dist

from rust_renderer_tpu_torch.app.main import MODES, SCENES, Application
from rust_renderer_tpu_torch.parallel.tiles import gather_rows, make_tile_group
from rust_renderer_tpu_torch.settings import StaticConfig
from rust_renderer_tpu_torch.utils.image_io import save_png


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description="row-banded frames over torch.distributed ranks")
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--height", type=int, default=512)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--mode", choices=[m for m in MODES if m != "hybrid"], default="pt")
    p.add_argument("--scene", choices=list(SCENES), default="default")
    p.add_argument("--out", default="frame.png")
    p.add_argument("--small", action="store_true",
                   help="shrink offscreen buffers (shadow/cubemap/LUT) for quick runs")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (one card a rank, by LOCAL_RANK) or 'cpu'")
    args = p.parse_args(argv)

    group, index = make_tile_group(device=args.device)
    cfg = None
    if args.small:
        cfg = StaticConfig(shadow_map_size=256, cubemap_size=64, cubemap_mips=4,
                           irradiance_size=16, brdf_lut_size=64, num_bounces=3)
    app = Application(args.width, args.height, MODES[args.mode], cfg, device=args.device)
    app.graph.shard_image_rows(group, args.height, args.width)
    app.create_scene(SCENES[args.scene])
    for _ in range(args.frames):
        band = app.render_frame()["present_output"]
    image = gather_rows(band, group)
    if index == 0:
        saved = save_png(args.out, image.cpu().numpy())
        print(f"ranks={dist.get_world_size(group)} band={tuple(band.shape)} saved={saved}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
