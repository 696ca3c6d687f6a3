"""The port's Scene and RenderScene (data/scene.py, data/readers.py) against
sdpgs_tpu's, on the CPU.

Each case writes one dataset tree under pytest's temporary directory and
loads it through both packages' ``Scene`` (the port's on
``device="cpu"``): an LLFF-flavoured COLMAP tree with an MVS
``3_views/dense/fused.ply`` and a pre-downsampled ``images_2``, the same
tree without the fused cloud (the random-cloud fallback), a DTU-flavoured
tree (its path names "dtu"), a Blender tree with PFM train depths and a
mip-NeRF-360 tree, and a reload from a saved PLY (``load_iteration``);
then ``RenderScene``'s spiral. The flavour that picks the pseudo-pose
generator comes from the path, so both packages load the same path.
Required: every camera's R, T, field of view, image, segment map,
features, depth, bounds and name, the prototypes, the pseudo poses and
``cameras_extent`` bit-equal; the model directories' ``cameras.json`` and
``input.ply`` byte-equal; the initial Gaussians within 1e-6 (the k-NN init
matches JAX's bit for bit on the CPU, so this holds with room).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest

from sdpgs_torch import config as tconfig
from sdpgs_torch.core.gaussians import BUFFER_FIELDS, PARAM_FIELDS
from sdpgs_torch.data import scene as tscene
from sdpgs_tpu import config as jconfig
from sdpgs_tpu.data import readers as jreaders
from sdpgs_tpu.data import scene as jscene
from test_scene import _write_png, make_blender_scene, make_colmap_scene

GAUSS_TOL = 1e-6
CAMERA_FIELDS = ("R", "T", "fovx", "fovy", "image", "depth_mono", "point_feature", "seg_map",
                 "feature_dict", "bounds", "image_name", "width", "height")


def same(a, b, what):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, what
        np.testing.assert_array_equal(a, b, err_msg=what)
    else:
        assert a == b and type(a) is type(b), (what, a, b)


def configs(root, out, **model):
    """The same TrainConfig for both packages; each writes its own model dir."""
    cfgs = []
    for mod, sub in ((jconfig, "jax"), (tconfig, "port")):
        cfg = mod.TrainConfig()
        m = cfg.model
        m.source_path, m.model_path = str(root), str(out / sub)
        m.language_features_name, m.nviews, m.capacity = "features_dim3", 3, 512
        for k, v in model.items():
            setattr(m, k, v)
        cfgs.append(cfg)
    return cfgs


def load_both(root, out, load_iteration=None, **model):
    jcfg, tcfg = configs(root, out, **model)
    js = jscene.Scene(jcfg, load_iteration=load_iteration)
    ts = tscene.Scene(tcfg, load_iteration=load_iteration, device="cpu")
    return js, ts


def llff_tree(root, fused: bool):
    """test_scene's 9-view 64x48 COLMAP tree, with half-size copies in
    images_2, mono depth PNGs for the test views, LLFF poses in
    poses_bounds.npy (the spiral's input; the bounds stay 1 and 10) and,
    with ``fused``, an MVS cloud of 300 points."""
    from PIL import Image

    make_colmap_scene(root)
    rng = np.random.default_rng(3)
    pb = np.load(root / "poses_bounds.npy")
    for i in range(len(pb)):
        c2w = np.eye(4)[:3]
        c2w[:, 3] = [0.2 * i - 1.0, 0.1 * rng.normal(), 0.05 * rng.normal()]
        pb[i, :15] = np.concatenate([c2w, [[48.0], [64.0], [60.0]]], axis=1).reshape(-1)
    np.save(root / "poses_bounds.npy", pb)
    (root / "images_2").mkdir()
    (root / "depth_maps").mkdir()
    rng = np.random.default_rng(10)
    for p in sorted((root / "images").iterdir()):
        Image.open(p).resize((32, 24), Image.BILINEAR).save(root / "images_2" / p.name)
        Image.fromarray(rng.integers(0, 256, (48, 64)).astype(np.uint8)).save(
            root / "depth_maps" / f"depth_{p.stem}.png")
    if fused:
        (root / "3_views" / "dense").mkdir(parents=True)
        jreaders.write_pointcloud_ply(
            root / "3_views" / "dense" / "fused.ply",
            rng.normal(size=(300, 3)) * 0.5 + [0, 0, 3], rng.uniform(size=(300, 3)))
    return root


def blender_tree(root):
    """test_scene's Blender tree, with PFM mono depths for the train views,
    PNG depths for the test views and language features for two views."""
    make_blender_scene(root)
    (root / "depth_maps").mkdir()
    (root / "features_dim3").mkdir()
    rng = np.random.default_rng(11)
    for i in range(20):
        jreaders.write_pfm(root / "depth_maps" / f"depth_r_{i}.pfm",
                           rng.uniform(1, 5, (24, 32)).astype(np.float32))
    _write_png(root / "depth_maps" / "depth_r_0.png", 24, 32, rng)
    for name in ("r_2", "r_16"):
        np.save(root / "features_dim3" / f"{name}_s.npy", rng.integers(0, 4, (24, 32)))
        np.save(root / "features_dim3" / f"{name}_fdim3.npy", rng.normal(size=(4, 3)))
    return root


def mipnerf360_tree(root):
    (root / "images").mkdir(parents=True)
    (root / "features_dim3").mkdir()
    rng = np.random.default_rng(12)
    W, H = 32, 24
    frames = []
    for i in range(10):
        ang = 2 * np.pi * i / 10
        c2w = np.eye(4)
        c2w[:3, 3] = [3 * np.cos(ang), 3 * np.sin(ang), 0.3 * rng.normal()]
        frames.append({"file_path": f"images/frame_{i:03d}.png",
                       "transform_matrix": c2w.tolist()})
        _write_png(root / "images" / f"frame_{i:03d}.png", H, W, rng, alpha=True)
        np.save(root / "features_dim3" / f"frame_{i:03d}_s.npy", rng.integers(0, 3, (H, W)))
        np.save(root / "features_dim3" / f"frame_{i:03d}_fdim3.npy", rng.normal(size=(3, 3)))
    (root / "transforms.json").write_text(json.dumps(
        {"fl_x": 30.0, "fl_y": 30.0, "w": W, "h": H, "cx": W / 2, "cy": H / 2,
         "frames": frames}))
    (root / "train_test_split_3.json").write_text(json.dumps(
        {"train_ids": [1, 4, 7], "test_ids": [0, 5]}))
    return root


# name -> (tree directory under the case's temporary directory, writer, Scene's model fields)
CASES = {
    "llff": ("llff_scene", lambda r: llff_tree(r, fused=True), dict(resolution=2)),
    "random_init": ("llff_scene", lambda r: llff_tree(r, fused=False), dict(resolution=2)),
    "dtu": ("dtu_scan1", lambda r: make_colmap_scene(r, n_views=30, W=16, H=12),
            dict(resolution=1, capacity=1024)),
    "blender": ("nerf_synthetic/lego", blender_tree, dict(resolution=1, white_background=True)),
    "mipnerf360": ("m360/garden", mipnerf360_tree, dict(resolution=1)),
}


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """Both packages' scenes for each case, built once per module."""
    out = {}
    for name, (sub, write, model) in CASES.items():
        base = tmp_path_factory.mktemp(name)
        root = base / sub
        root.mkdir(parents=True)
        write(root)
        out[name] = (*load_both(root, base / "out", **model), base, root, model)
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_cameras_match(loaded, case):
    js, ts = loaded[case][:2]
    assert len(ts.train_cameras) == len(js.train_cameras) > 0
    assert len(ts.test_cameras) == len(js.test_cameras) > 0
    for kind in ("train_cameras", "test_cameras"):
        for i, (tc, jc) in enumerate(zip(getattr(ts, kind), getattr(js, kind))):
            for k in CAMERA_FIELDS:
                a, b = getattr(tc, k), getattr(jc, k)
                if a is None or b is None:
                    assert a is None and b is None, (kind, i, k)
                else:
                    same(a, b, f"{kind}[{i}].{k}")
            assert tc.camera.view.device.type == "cpu"
            for k in ("view", "full_proj", "cam_pos", "tan_fovx", "tan_fovy"):
                same(getattr(tc.camera, k).numpy(), np.asarray(getattr(jc.camera, k)),
                     f"{kind}[{i}].camera.{k}")
    # train views carry the unified segments
    assert all(c.seg_map is not None for c in ts.train_cameras)


@pytest.mark.parametrize("case", list(CASES))
def test_prototypes_pseudo_poses_extent(loaded, case):
    js, ts = loaded[case][:2]
    same(ts.prototypes, js.prototypes, "prototypes")
    same(ts.pseudo_poses, js.pseudo_poses, "pseudo_poses")
    assert ts.pseudo_poses.shape == (10000, 4, 4)
    assert ts.cameras_extent == js.cameras_extent > 0
    for idx in (0, 4321):
        tcam, tR, tT = ts.pseudo_camera(idx)
        jcam, jR, jT = js.pseudo_camera(idx)
        same(tR, jR, "pseudo R")
        same(tT, jT, "pseudo T")
        assert tcam.view.device.type == "cpu"
        same(tcam.full_proj.numpy(), np.asarray(jcam.full_proj), "pseudo full_proj")


@pytest.mark.parametrize("case", list(CASES))
def test_initial_gaussians(loaded, case):
    js, ts = loaded[case][:2]
    got = ts.gaussians.to_numpy()
    assert ts.gaussians.xyz.device.type == "cpu"
    for k in PARAM_FIELDS + BUFFER_FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(js.gaussians, k)), rtol=0,
                                   atol=GAUSS_TOL, err_msg=k)
    model = loaded[case][-1]
    n_init = min(len(js.info.points), model.get("capacity", 512))
    assert int(got["alive"].sum()) == n_init > 0


@pytest.mark.parametrize("case", list(CASES))
def test_provenance_files(loaded, case):
    base = loaded[case][2]
    jdir, tdir = base / "out" / "jax", base / "out" / "port"
    assert (tdir / "cameras.json").read_text() == (jdir / "cameras.json").read_text()
    if (jdir / "input.ply").exists():
        assert (tdir / "input.ply").read_bytes() == (jdir / "input.ply").read_bytes()
    else:
        assert not (tdir / "input.ply").exists()
    assert (tdir / "input.ply").exists() == (case != "blender")   # Blender keeps its draw in memory


def test_random_init_writes_into_the_source_tree(loaded):
    """The fallback writes sparse/0/points3D_random.ply into the dataset, as
    JAX does; both packages' clouds come from the same seeded draw."""
    js, ts, _, root, _ = loaded["random_init"]
    ply = root / "sparse" / "0" / "points3D_random.ply"
    assert ply.exists() and ts.info.ply_path == js.info.ply_path == str(ply)
    same(ts.info.points, js.info.points, "random points")
    same(ts.info.colors, js.info.colors, "random colours")


def save_to(model_path, iteration, gaussians):
    """Scene.save into another model directory than the scene's own."""
    tscene.Scene.save(SimpleNamespace(model_path=model_path), iteration, gaussians)


def test_scene_from_saved_ply(loaded, tmp_path):
    """load_iteration: both packages reload the PLY the port's Scene.save
    wrote."""
    _, ts, _, root, model = loaded["llff"]
    jcfg, tcfg = configs(root, tmp_path, **model)
    jcfg.model.model_path = tcfg.model.model_path = str(tmp_path / "model")
    save_to(tcfg.model.model_path, 7, ts.gaussians)
    js2 = jscene.Scene(jcfg, load_iteration=7)
    ts2 = tscene.Scene(tcfg, load_iteration=7, device="cpu")
    got, init = ts2.gaussians.to_numpy(), ts.gaussians.to_numpy()
    for k in PARAM_FIELDS + BUFFER_FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(js2.gaussians, k)), rtol=0,
                                   atol=GAUSS_TOL, err_msg=k)
        np.testing.assert_allclose(got[k], init[k], rtol=0, atol=GAUSS_TOL, err_msg=k)
    same(ts2.pseudo_poses, js2.pseudo_poses, "pseudo_poses")
    # a reload writes no provenance
    assert sorted(p.name for p in (tmp_path / "model").iterdir()) == ["point_cloud"]


def test_render_scene(loaded, tmp_path):
    """The spiral render scene (reference RenderScene): cameras from
    poses_bounds.npy, the cloud from the newest saved iteration."""
    _, ts, _, root, model = loaded["llff"]
    jcfg, tcfg = configs(root, tmp_path, **model)
    jcfg.model.model_path = tcfg.model.model_path = str(tmp_path / "model")
    for it in (3, 12):
        save_to(tcfg.model.model_path, it, ts.gaussians)

    jr = jscene.RenderScene(jcfg, n_frames=6)
    tr = tscene.RenderScene(tcfg, n_frames=6, device="cpu")
    assert tr.loaded_iter == jr.loaded_iter == 12
    assert tr.cameras_extent == jr.cameras_extent
    assert len(tr.render_cameras) == len(jr.render_cameras) == 6
    for i, (tc, jc) in enumerate(zip(tr.render_cameras, jr.render_cameras)):
        for k in CAMERA_FIELDS:
            a, b = getattr(tc, k), getattr(jc, k)
            if a is None:
                assert b is None
            else:
                same(a, b, f"render[{i}].{k}")
        same(tc.camera.full_proj.numpy(), np.asarray(jc.camera.full_proj), f"render[{i}]")
    assert tr.render_cameras[0].width == 32
    R = tr.render_cameras[0].R
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
    got = tr.gaussians.to_numpy()
    for k in PARAM_FIELDS + BUFFER_FIELDS:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jr.gaussians, k)), rtol=0,
                                   atol=GAUSS_TOL, err_msg=k)


def test_detect_scene_type(loaded):
    kinds = {"llff": "colmap", "random_init": "colmap", "dtu": "colmap", "blender": "blender",
             "mipnerf360": "mipnerf360"}
    for case, kind in kinds.items():
        root = loaded[case][3]
        assert tscene.detect_scene_type(str(root)) == jscene.detect_scene_type(str(root)) == kind
    for path in ("/data/dtu/scan8", "/data/mip360/garden", "/data/nerf_synthetic/lego",
                 "/data/blender/x", "/data/llff/fern", "/data/DTU"):
        assert tscene.Scene._flavor(path) == jscene.Scene._flavor(path)
    with pytest.raises(ValueError, match="could not recognize"):
        tscene.detect_scene_type(str(loaded["llff"][2] / "out"))


def test_unify_segments_in_place():
    """Per-view ids merge into one global space; each prototype averages its
    segment's features over the views that see it."""
    from sdpgs_torch.data.camera_utils import LoadedCamera
    from sdpgs_tpu.data.camera_utils import LoadedCamera as JLoadedCamera

    rng = np.random.default_rng(6)
    views = []
    for ids in ([0, 2, 5], [2, 3], [7]):
        seg = rng.choice(ids, (6, 8)).astype(np.int32)
        seg[0, 0] = -1
        views.append((seg, rng.normal(size=(len(ids), 3)).astype(np.float32)))
    tcams = [LoadedCamera(camera=None, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=1.0,
                          seg_map=s.copy(), feature_dict=f.copy()) for s, f in views]
    jcams = [JLoadedCamera(camera=None, R=np.eye(3), T=np.zeros(3), fovx=1.0, fovy=1.0,
                           seg_map=s.copy(), feature_dict=f.copy()) for s, f in views]
    protos = tscene.unify_segments(tcams)
    same(protos, jscene.unify_segments(jcams), "prototypes")
    assert protos.shape == (5, 3)      # ids 0, 2, 3, 5, 7
    for i, (tc, jc) in enumerate(zip(tcams, jcams)):
        for k in ("seg_map", "point_feature", "feature_dict"):
            same(getattr(tc, k), getattr(jc, k), f"view {i} {k}")
    np.testing.assert_allclose(protos[1], (views[0][1][1] + views[1][1][0]) / 2, rtol=1e-6)
