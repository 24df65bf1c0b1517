"""`Graph.render_loop` on a row-sharded graph (`Graph.shard_image_rows`):
`Application.run_on_device` on 2 gloo ranks against the same ranks' host
loop, and against one rank, for the PT app and the RASTERIZED app with the
marching-cubes draw (mc_grid 8).

The scene and configuration are tests/test_torch_loop.py's (the cube on a
floor, two lights, 32x32, 2 bounces, the clock pinned). Each rank renders
its band: the device loop runs the frame body, collectives included, once a
frame, so on CPU tensors (the body eager, no capture) its state and
presented band must equal the host loop's bit for bit. Gathered, the band
frames hold the one-rank loop's frame within 2e-5, the bound that
tests/test_torch_parallel.py holds the sharded PT graph to (3e-5 for the
RASTERIZED frame, tests/test_torch_parallel_raster.py's). The ranks are
spawned once for the module (a file store under the test's temporary
directory, no network port); this module imports no jax, as they import it.
"""

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.parallel import make_tile_group, spawn_ranks, tiles
from rust_renderer_tpu_torch.scene import ModelLoader
from rust_renderer_tpu_torch.settings import RenderGraphMode, StaticConfig
from rust_renderer_tpu_torch.utils import math3d

torch.set_num_threads(1)

W = H = 32
RANKS, FRAMES = 2, 3
CFG = StaticConfig(width=W, height=H, shadow_map_size=64, cubemap_size=16, cubemap_mips=2,
                   irradiance_size=8, brdf_lut_size=16, num_bounces=2)


def _scene(r, cam):
    r.add_model(ModelLoader.load_cube(), math3d.translation([0, 0.5, 0]))
    r.add_model(ModelLoader.load_cube(), math3d.scale([20.0, 0.1, 20.0]))
    r.add_light([2.0, 3.0, 2.0], [1.0, 1.0, 1.0], 1.0)
    r.add_light([-2.0, 2.0, -1.0], [1.0, 0.5, 0.2], 0.7)
    cam.set_position_target([3, 2, 5], [0, 0.5, 0])


def _app(group=None, mode=RenderGraphMode.PATH_TRACED) -> Application:
    raster = mode == RenderGraphMode.RASTERIZED
    app = Application(W, H, mode, CFG.replace(mc_grid=8) if raster else CFG, device="cpu")
    app.view = app.view.replace(marching_cubes_enabled=np.int32(raster))
    if group is not None:
        app.graph.shard_image_rows(group, H, W)
    app.create_scene(_scene)
    app.fps_timer.elapsed_seconds = lambda: 0.0
    return app


def _rank(rank, n):
    """One rank: FRAMES host frames and one FRAMES-frame device loop of the
    row-sharded PT app from the same state; the bands, the loop's form and
    reasons, and the gathered loop frame; then the same of the row-sharded
    RASTERIZED app (under "raster")."""
    group, index = make_tile_group(device="cpu")
    out = {"index": index}
    for key, mode in (("pt", RenderGraphMode.PATH_TRACED),
                      ("raster", RenderGraphMode.RASTERIZED)):
        host, loop = _app(group, mode), _app(group, mode)
        want = host.run(FRAMES)
        reason = loop.graph.device_loop_unsupported_reason()
        img = loop.run_on_device(FRAMES, tstep=0.0)
        got = {
            "reason": reason, "form": loop.graph.last_loop_form,
            "capture": loop.graph.capture_unsupported_reason(),
            "host": want, "loop": img.numpy(),
            "state_equal": {k: torch.equal(t, loop.graph.state[k])
                            for k, t in host.graph.state.items()},
            "state_keys": sorted(loop.graph.state) == sorted(host.graph.state),
            "samples": (host.total_samples, loop.total_samples),
            "whole": tiles.gather_rows(img, group).numpy(),
            "band": tuple(img.shape),
            "passes": [p.name for p in loop.graph.passes],
        }
        out.update(got if key == "pt" else {"raster": got})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return spawn_ranks(_rank, RANKS, str(tmp_path_factory.mktemp("ranks")), threads=1)


def test_sharded_device_loop_runs_eagerly_over_gloo(ranks):
    """The device loop takes the row-sharded graph; over gloo (and on CPU
    tensors) it runs its body eagerly and says why."""
    assert [r["index"] for r in ranks] == list(range(RANKS))
    for r in ranks:
        assert r["reason"] is None
        assert r["form"].startswith("eager: ")
        assert r["capture"].startswith("gloo collectives cannot be captured")
        assert r["band"] == (H // RANKS, W, 3)


def test_sharded_device_loop_equals_the_host_loop(ranks):
    for r in ranks:
        np.testing.assert_array_equal(r["loop"], r["host"])
        assert r["state_keys"] and all(r["state_equal"].values()), r["state_equal"]
        assert r["samples"] == (FRAMES, FRAMES)


def test_sharded_device_loop_gathers_to_the_one_rank_loop(ranks):
    want = _app().run_on_device(FRAMES, tstep=0.0).numpy()
    for r in ranks:
        np.testing.assert_allclose(r["whole"], want, atol=2e-5)
    assert np.isfinite(want).all() and want.std() > 1e-3


def test_sharded_raster_device_loop_runs_eagerly_and_equals_the_host_loop(ranks):
    """The row-sharded RASTERIZED app (its shadow cascades, binning and
    marching-cubes draw included) takes the device loop: no pass asks for a
    host sync, so over gloo the one reason to run eagerly is gloo's; the
    loop's band equals the host loop's bit for bit."""
    for r in ranks:
        got = r["raster"]
        assert "shadow" in got["passes"] and "marching_cubes" in got["passes"]
        assert got["reason"] is None
        assert got["form"].startswith("eager: ")
        assert got["capture"].startswith("gloo collectives cannot be captured")
        assert got["band"] == (H // RANKS, W, 3)
        np.testing.assert_array_equal(got["loop"], got["host"])
        assert got["state_keys"] and all(got["state_equal"].values()), got["state_equal"]
        assert got["samples"] == (FRAMES, FRAMES)


def test_sharded_raster_device_loop_gathers_to_the_one_rank_loop(ranks):
    app = _app(mode=RenderGraphMode.RASTERIZED)
    want = app.run_on_device(FRAMES, tstep=0.0).numpy()
    assert app.graph.last_loop_form == "eager: no CUDA graphs on cpu"
    for r in ranks:
        np.testing.assert_allclose(r["raster"]["whole"], want, atol=3e-5)
    assert np.isfinite(want).all() and want.std() > 1e-3
