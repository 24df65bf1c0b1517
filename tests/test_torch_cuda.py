"""Kernel K1 on the card, and the guards of its wrapper.

This file imports torch and the port only, never jax, so that it runs on a
GPU machine without jax (tests/conftest.py imports jax, hence
``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -q --noconftest -p no:cacheprovider

Tests marked `cuda` skip where torch sees no GPU. On the card, K1 must
return the plain walk's hits: t to rtol 1e-6, prim equal off exact ties,
any-hit flags equal; the whole frame must match the CPU's under the
tolerance of tests/test_torch_slice.py.
"""

import numpy as np
import pytest
import torch

from rust_renderer_tpu_torch.app.main import Application
from rust_renderer_tpu_torch.ops import bvh as torch_bvh
from rust_renderer_tpu_torch.ops import traversal
from rust_renderer_tpu_torch.settings import StaticConfig

torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel K1 needs an NVIDIA GPU and nvcc")
    return torch.device("cuda")


def _soup_tree(device, n=3000, seed=11):
    rng = np.random.default_rng(seed)
    base = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    e = rng.uniform(-0.8, 0.8, (n, 2, 3)).astype(np.float32)
    pos = np.concatenate([base, base + e[:, 0], base + e[:, 1]], 1).reshape(-1, 3)
    return torch_bvh.build_bvh(pos, np.arange(n * 3).reshape(-1, 3), device)


def _rays(device, n, seed=12):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[::61] = 0.0
    t_max = rng.uniform(2.0, 20.0, n).astype(np.float32)
    t_min = np.full(n, 1e-3, np.float32)
    return [torch.tensor(x, device=device) for x in (o, d, t_min, t_max)]


def test_k1_wrapper_refuses_cpu_tensors_and_deep_trees():
    tree = _soup_tree("cpu", n=50)
    o, d, t_min, t_max = _rays("cpu", 8)
    with pytest.raises(ValueError, match="CUDA"):
        traversal.traverse_wide_cuda(tree.wnode_packed, tree.leaf_packed,
                                     tree.wide_depth, o, d, t_min, t_max, False)
    assert traversal.k1_stack_need(tree.wide_depth) <= traversal.K1_STACK_CAP
    assert traversal.k1_stack_need(16) > traversal.K1_STACK_CAP
    with pytest.raises(ValueError, match="device"):
        traversal.traverse(tree, o.to("meta"), d.to("meta"))


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_k1_matches_plain_on_card(cuda_device, any_hit):
    tree = _soup_tree(cuda_device)
    o, d, t_min, t_max = _rays(cuda_device, 50000)
    k1 = traversal.traverse_wide_cuda(tree.wnode_packed, tree.leaf_packed,
                                      tree.wide_depth, o, d, t_min, t_max, any_hit)
    plain = traversal.traverse_plain(tree.node_packed, tree.leaf_packed, o, d, t_min,
                                     t_max, any_hit)
    t1, p1 = (x.cpu().numpy() for x in k1[:2])
    t2, p2 = (x.cpu().numpy() for x in plain[:2])
    np.testing.assert_array_equal(p1 >= 0, p2 >= 0)
    assert (p2 >= 0).sum() > 1000
    if not any_hit:
        hit = p2 >= 0
        np.testing.assert_allclose(t1[hit], t2[hit], rtol=1e-6)
        assert np.all((p1 == p2) | np.isclose(t1, t2, rtol=1e-6, atol=0))


@pytest.mark.cuda
def test_pt_frame_on_card_matches_cpu(cuda_device):
    size, frames, bounces = 64, 2, 3

    def render(device):
        app = Application(size, size, cfg=StaticConfig(num_bounces=bounces),
                          device=device)
        app.fps_timer.elapsed_seconds = lambda: 0.25
        app.create_scene()
        out = []
        for _ in range(frames):
            img = app.render_frame()["present_output"].cpu().numpy()
            out.append((img, float(app.graph.state["pt_rays"].cpu())))
        return out

    traversal.K1_LAUNCHES.clear()
    got = render(cuda_device)
    assert dict(traversal.K1_LAUNCHES) == {"closest": (1 + bounces) * frames,
                                           "any_hit": bounces * frames}
    for (img, rays), (ref, ref_rays) in zip(got, render("cpu")):
        assert rays == ref_rays
        diff = np.abs(img - ref)
        assert (diff.max(axis=-1) <= 1e-3).mean() >= 0.99
        assert diff.mean() <= 1e-3
