"""The pseudo cameras follow the scene's layout, and the depth net builds
with or without the BiT stem."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import poses as pose_lib, program, scene as scene_lib, spec
from benchmark.train_cell import reference_depth

ROOT = Path(__file__).resolve().parents[2]
SEED = 2021


def config(name: str) -> dict:
    return json.loads((ROOT / "benchmark" / "configs" / f"{name}.json").read_text())


def m360_ring(seed: int = SEED):
    """m360's train views and the generator as ``scene.build`` leaves it
    once it has drawn them."""
    cfg = config("m360-garden-24view")
    rng = np.random.default_rng(seed)
    return cfg, scene_lib.train_views(cfg["layout"], cfg["image"], rng), rng


def test_the_360_sampler_is_the_programs():
    from sdpgs_torch.data import pose_sampling

    _, views, rng = m360_ring()
    state = rng.bit_generator.state
    Rs, Ts = [v.R for v in views], [v.T for v in views]
    ours = pose_lib.generate_random_poses_360(Rs, Ts, n_poses=500, rng=rng)
    rng.bit_generator.state = state
    theirs = pose_sampling.generate_random_poses_360(Rs, Ts, n_poses=500, rng=rng)
    assert ours.shape == (500, 4, 4)
    np.testing.assert_allclose(ours, theirs, rtol=0, atol=1e-12)


def test_fern_pseudo_poses_are_the_llff_samplers(small_bench):
    """Each fern configuration's pseudo poses, from ``scene.build``, equal
    bit for bit a direct call of the LLFF sampler on the generator drawn as
    before: the train views, then the isolated Gaussians where there are
    such."""
    for name in ("llff-fern-3view", "llff-fern-3view-early"):
        cfg = json.loads((small_bench / "configs" / f"{name}.json").read_text())
        sc = scene_lib.build(cfg, SEED, torch.device("cpu"), with_pseudo=True)
        rng = np.random.default_rng(SEED)
        views = scene_lib.train_views(cfg["layout"], cfg["image"], rng)
        if "isolated" in cfg["cloud"]:
            scene_lib.isolated_positions(cfg["cloud"]["isolated"], rng)
        direct = pose_lib.generate_random_poses_llff(
            [v.R for v in views], [v.T for v in views], sc.bounds,
            n_poses=cfg["layout"]["n_pseudo"], rng=rng)
        assert np.array_equal(sc.pseudo_poses, direct), name


def seen_shares(poses: np.ndarray, xyz: np.ndarray, size: dict, near: float) -> np.ndarray:
    """The share of ``xyz`` each world-to-camera pose projects in front of
    ``near`` and inside the image."""
    fx = size["width"] / (2.0 * np.tan(size["fovx"] / 2.0))
    fy = size["height"] / (2.0 * np.tan(size["fovy"] / 2.0))
    cam = np.einsum("nij,pj->npi", poses[:, :3, :3], xyz) + poses[:, None, :3, 3]
    z = cam[..., 2]
    front = z > near
    z = np.where(front, z, 1.0)
    u = fx * cam[..., 0] / z + size["width"] / 2.0
    v = fy * cam[..., 1] / z + size["height"] / 2.0
    inside = front & (u >= 0) & (u < size["width"]) & (v >= 0) & (v < size["height"])
    return inside.mean(axis=1)


def test_m360_pseudo_cameras_see_the_scene():
    """m360's first 64 pseudo cameras, from the 360 sampler, each see at
    least half of the hidden ball's centres; the LLFF sampler's, on the
    same views, would not."""
    cfg, views, rng = m360_ring()
    layout, size = cfg["layout"], cfg["image"]
    cloud = dict(cfg["cloud"], capacity=8192, alive=8192)
    protos = torch.eye(3)
    gen = scene_lib.generator(SEED, "cpu")
    xyz = scene_lib.make_cloud(gen, cloud, layout, 3, protos, "cpu")["xyz"].double().numpy()
    near = cfg["raster"]["near"]
    state = rng.bit_generator.state
    poses = scene_lib.pseudo_poses(dict(layout, n_pseudo=64), views, None, rng)
    shares = seen_shares(poses, xyz, size, near)
    assert poses.shape == (64, 4, 4) and shares.min() >= 0.5, shares.min()
    # the train views see the ball as the pseudo cameras do
    train = np.stack([np.concatenate([np.concatenate([v.R.T, v.T[:, None]], 1),
                                      [[0, 0, 0, 1.0]]]) for v in views])
    assert seen_shares(train, xyz, size, near).min() >= 0.5
    # each view's depth bounds, as ``scene.build`` takes them from its render
    depths = [(p[:3, :3] @ xyz.T + p[:3, 3:4])[2] for p in train]
    bounds = np.stack([np.percentile(d[d > near], [1.0, 99.0]) for d in depths])
    rng.bit_generator.state = state
    llff = pose_lib.generate_random_poses_llff([v.R for v in views], [v.T for v in views],
                                               bounds, n_poses=64, rng=rng)
    assert np.median(seen_shares(llff, xyz, size, near)) < 0.5


def test_an_unknown_layout_has_no_sampler():
    _, views, rng = m360_ring()
    with pytest.raises(ValueError, match="aerial"):
        scene_lib.pseudo_poses({"kind": "aerial", "n_pseudo": 4}, views, None, rng)


TINY_PLAIN = {"hidden_size": 32, "num_layers": 4, "num_heads": 2, "intermediate_size": 64,
              "patch_size": 16, "backbone_out_indices": [0, 1, 2, 3],
              "neck_hidden_sizes": [8, 12, 24, 32], "reassemble_factors": [4, 2, 1, 0.5],
              "fusion_hidden_size": 16, "layer_norm_eps": 1e-12, "is_hybrid": False}


def test_a_depth_net_without_the_stem_builds_in_both():
    """A net without ``bit`` (``DPTArch.tiny``'s sizes, DPT-Large's plain
    ViT and transposed-convolution reassembly): the program's and the
    reference's have the same parameters, and agree on the CPU."""
    from sdpgs_torch.models.dpt import DPTArch

    cfg = {"depth_net": dict(config("llff-fern-3view")["depth_net"], arch=TINY_PLAIN,
                             dtype="float32")}
    want = DPTArch.tiny()
    got = program.arch_of(TINY_PLAIN, DPTArch, None)
    assert got == want and got.bit is None and program.ref_dpt_arch(cfg).bit is None
    dev = torch.device("cpu")
    shapes = program.dpt_names_shapes(cfg)
    weights = scene_lib.dpt_weights(shapes, SEED, dev, torch.float32)
    net = program.depth_net(cfg, weights, dev)
    assert sorted((k, tuple(v.shape)) for k, v in net.net.state_dict().items()) == shapes
    ref = reference_depth(cfg, weights, dev)
    image = torch.rand((3, 48, 64), generator=torch.Generator().manual_seed(SEED))
    with torch.no_grad():
        a, b = net(image), ref(image)
    assert a.shape == (48, 64) and torch.isfinite(a).all() and a.abs().max() > 0
    # float32 on the CPU, the same operations in both: equal but for rounding
    # (the random weights make the depths small, so the tolerance is relative)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=0)


def test_the_m360_pseudo_cell_is_found():
    """``m360-train-pseudo``: m360's scene under the pseudo window, with the
    fern pseudo cell's numbers compared."""
    cell = spec.load_cell("m360-train-pseudo")
    fern = spec.load_cell("llff-train-pseudo")
    assert cell.config["layout"]["kind"] == "inward" and cell.config["layout"]["n_pseudo"] == 10000
    assert cell.traffic == fern.traffic
    assert set(cell.limits["limits"]) == set(fern.limits["limits"])
