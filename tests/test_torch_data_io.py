"""The port's host-side data layer (data/{colmap,stepfun,pose_sampling,
readers,ply,camera_utils}.py) against sdpgs_tpu's, on the CPU.

Both packages parse the same COLMAP models (binary and text, written here
with keypoints and tracks), read each other's PFMs and point-cloud PLYs,
and run every pose generator and ``stepfun.sample_np`` on the same
``default_rng``. The port keeps JAX's numpy code operation for operation,
so every result must be bit-equal.
"""

import json
import struct

import numpy as np
import pytest

from sdpgs_torch.data import camera_utils as tcu
from sdpgs_torch.data import colmap as tcolmap
from sdpgs_torch.data import ply as tply
from sdpgs_torch.data import pose_sampling as tpose
from sdpgs_torch.data import readers as treaders
from sdpgs_torch.data import stepfun as tstep
from sdpgs_tpu.data import camera_utils as jcu
from sdpgs_tpu.data import colmap as jcolmap
from sdpgs_tpu.data import ply as jply
from sdpgs_tpu.data import pose_sampling as jpose
from sdpgs_tpu.data import readers as jreaders
from sdpgs_tpu.data import stepfun as jstep

def same(a, b):
    """Bit-equal arrays, dataclasses, dicts, lists and scalars."""
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif hasattr(a, "__dataclass_fields__"):
        for k in a.__dataclass_fields__:
            same(getattr(a, k), getattr(b, k))
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b and type(a) is type(b), (a, b)


# ---- COLMAP -----------------------------------------------------------------

N_IMAGES, N_POINTS, N_KP = 4, 12, 6


def colmap_model(rng):
    """Two cameras (PINHOLE, SIMPLE_RADIAL), N_IMAGES posed images with
    N_KP keypoints each, N_POINTS points whose tracks name (image,
    keypoint) pairs."""
    cams = [(1, 1, 640, 480, [500.0, 510.0, 320.0, 240.0]),
            (2, 2, 320, 240, [250.0, 160.0, 120.0, 0.01])]
    images = []
    for iid in range(1, N_IMAGES + 1):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        images.append(dict(id=iid, q=q, t=rng.normal(size=3), cam=1 + iid % 2,
                           name=f"img_{iid:02d}.jpg", xy=rng.uniform(0, 300, (N_KP, 2)),
                           pid=rng.integers(-1, N_POINTS, N_KP)))
    points = []
    for pid in range(N_POINTS):
        track = [(int(i), int(k)) for i, k in
                 zip(rng.integers(1, N_IMAGES + 1, 3), rng.integers(0, N_KP, 3))]
        points.append(dict(id=pid, xyz=rng.normal(size=3) + [0, 0, 4],
                           rgb=rng.integers(0, 256, 3), err=float(rng.uniform()),
                           track=track))
    return cams, images, points


def write_colmap_binary(d, model):
    cams, images, points = model
    with open(d / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cid, mid, w, h, params in cams:
            f.write(struct.pack("<iiQQ", cid, mid, w, h))
            f.write(struct.pack("<" + "d" * len(params), *params))
    with open(d / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images:
            f.write(struct.pack("<i", im["id"]))
            f.write(struct.pack("<dddd", *im["q"]))
            f.write(struct.pack("<ddd", *im["t"]))
            f.write(struct.pack("<i", im["cam"]))
            f.write(im["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", N_KP))
            for (x, y), p in zip(im["xy"], im["pid"]):
                f.write(struct.pack("<ddq", x, y, int(p)))
    with open(d / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", len(points)))
        for p in points:
            f.write(struct.pack("<Q", p["id"]))
            f.write(struct.pack("<ddd", *p["xyz"]))
            f.write(struct.pack("<BBB", *(int(c) for c in p["rgb"])))
            f.write(struct.pack("<d", p["err"]))
            f.write(struct.pack("<Q", len(p["track"])))
            for i, k in p["track"]:
                f.write(struct.pack("<ii", i, k))


def write_colmap_text(d, model):
    cams, images, points = model
    names = {1: "PINHOLE", 2: "SIMPLE_RADIAL"}

    def row(*vals):
        return " ".join(str(v) if isinstance(v, (int, np.integer, str)) else repr(float(v))
                        for v in vals)

    lines = ["# Camera list"] + [row(cid, names[mid], w, h, *params)
                                 for cid, mid, w, h, params in cams]
    (d / "cameras.txt").write_text("\n".join(lines) + "\n")
    lines = ["# Image list"]
    for im in images:
        lines.append(row(im["id"], *im["q"], *im["t"], im["cam"], im["name"]))
        lines.append(" ".join(row(x, y, int(p)) for (x, y), p in zip(im["xy"], im["pid"])))
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    lines = ["# 3D point list"]
    for p in points:
        lines.append(row(p["id"], *p["xyz"], *(int(c) for c in p["rgb"]), p["err"],
                         *(v for ik in p["track"] for v in ik)))
    (d / "points3D.txt").write_text("\n".join(lines) + "\n")


@pytest.mark.parametrize("fmt", ["binary", "text"])
def test_colmap_model_parsing(tmp_path, fmt):
    model = colmap_model(np.random.default_rng(0))
    (write_colmap_binary if fmt == "binary" else write_colmap_text)(tmp_path, model)
    got, ref = tcolmap.detect_model_dir(tmp_path), jcolmap.detect_model_dir(tmp_path)
    same(got, ref)
    cams, images, points = got
    assert sorted(cams) == [1, 2] and cams[2].model == "SIMPLE_RADIAL"
    assert len(images) == N_IMAGES and images[3].xys.shape == (N_KP, 2)
    assert points[0].shape == (N_POINTS, 3)
    np.testing.assert_array_equal(images[2].point3D_ids, model[1][1]["pid"])


def test_colmap_sparse_depth(tmp_path):
    model = colmap_model(np.random.default_rng(1))
    write_colmap_binary(tmp_path, model)
    train = [1, 3]
    got = tcolmap.read_points3D_binary_sparse(tmp_path / "points3D.bin", train)
    ref = jcolmap.read_points3D_binary_sparse(tmp_path / "points3D.bin", train)
    same(got, ref)
    xyz, _, _, view_xy, view_pid = got
    assert sorted(view_xy) == train and sum(len(v) for v in view_pid.values()) > 0
    images = tcolmap.read_images_binary(tmp_path / "images.bin")
    K = np.array([[500.0, 0, 320], [0, 510.0, 240], [0, 0, 1]])
    for iid in train:
        same(tcolmap.sparse_depth_for_view(xyz, view_pid[iid], view_xy[iid], images[iid], K,
                                           640, 480),
             jcolmap.sparse_depth_for_view(xyz, view_pid[iid], view_xy[iid], images[iid], K,
                                           640, 480))


def test_qvec_rotmat(rng):
    q = rng.normal(size=(16, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    for qi in q:
        R = tcolmap.qvec2rotmat(qi)
        same(R, jcolmap.qvec2rotmat(qi))
        back = tcolmap.rotmat2qvec(R)
        same(back, jcolmap.rotmat2qvec(R))
        np.testing.assert_allclose(back, qi * np.sign(qi[0]), atol=1e-9)


# ---- PFM, point-cloud PLY -----------------------------------------------------

@pytest.mark.parametrize("color", [False, True], ids=["gray", "color"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pfm_across_packages(tmp_path, rng, color, writer):
    data = rng.normal(size=(7, 5, 3) if color else (7, 5)).astype(np.float32)
    path = tmp_path / "d.pfm"
    (jreaders if writer == "jax" else treaders).write_pfm(path, data)
    for reader in (jreaders, treaders):
        same(reader.read_pfm(path), data)


@pytest.mark.parametrize("colors", [True, False], ids=["rgb", "plain"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pointcloud_ply_across_packages(tmp_path, rng, colors, writer):
    pts = rng.normal(size=(40, 3)).astype(np.float32)
    cols = rng.uniform(size=(40, 3)).astype(np.float32) if colors else None
    normals = rng.normal(size=(40, 3)).astype(np.float32)
    path = tmp_path / "pc.ply"
    (jply if writer == "jax" else tply).write_pointcloud_ply(path, pts, cols, normals)
    got = tply.read_pointcloud_ply(path)
    same(got, jply.read_pointcloud_ply(path))
    same(got[0], pts)
    same(got[2], normals)


# ---- pose generators and stepfun ------------------------------------------------

def camera_rig(rng, n=5, spread=0.3):
    """n cameras (C2W rotation R, W2C translation T) around a scene at
    z ~ 4, and LLFF-style [n, 2] near/far bounds."""
    Rs, Ts = [], []
    for _ in range(n):
        rvec = rng.normal(size=3) * 0.1
        R = tpose._rodrigues_to_mat(rvec)
        Rs.append(R)
        Ts.append(rng.normal(size=3) * spread)
    bounds = np.stack([rng.uniform(1.0, 2.0, n), rng.uniform(8.0, 12.0, n)], -1)
    return Rs, Ts, bounds


GENERATORS = {
    "llff": lambda m, Rs, Ts, b, rng: m.generate_random_poses_llff(Rs, Ts, b, n_poses=200,
                                                                   rng=rng),
    "interp": lambda m, Rs, Ts, b, rng: m.generate_random_poses_interp(Rs, Ts, n_poses=200,
                                                                       rng=rng),
    "360": lambda m, Rs, Ts, b, rng: m.generate_random_poses_360(Rs, Ts, n_poses=200,
                                                                 rng=rng),
    "spiral": lambda m, Rs, Ts, b, rng: m.generate_spiral_path(Rs, Ts, b, n_frames=48),
    "ellipse": lambda m, Rs, Ts, b, rng: m.generate_ellipse_path(Rs, Ts, n_frames=60,
                                                                 z_variation=0.2),
    "ellipse_uniform": lambda m, Rs, Ts, b, rng: m.generate_ellipse_path(
        Rs, Ts, n_frames=30, const_speed=False),
}


@pytest.mark.parametrize("name", list(GENERATORS))
def test_pose_generators_match(name):
    Rs, Ts, bounds = camera_rig(np.random.default_rng(3))
    got = GENERATORS[name](tpose, Rs, Ts, bounds, np.random.default_rng(7))
    ref = GENERATORS[name](jpose, Rs, Ts, bounds, np.random.default_rng(7))
    same(got, ref)
    assert got.shape[1:] == (4, 4) and np.isfinite(got).all()
    R = got[:, :3, :3]
    np.testing.assert_allclose(R @ R.transpose(0, 2, 1), np.broadcast_to(np.eye(3), R.shape),
                               atol=1e-6)


def test_pose_helpers_match():
    rng = np.random.default_rng(4)
    Rs, Ts, bounds = camera_rig(rng, n=6)
    poses = np.stack([tpose._c2w_from_camera(R, T) for R, T in zip(Rs, Ts)])
    same(poses, np.stack([jpose._c2w_from_camera(R, T) for R, T in zip(Rs, Ts)]))
    same(tpose.focus_point_fn(poses), jpose.focus_point_fn(poses))
    same(tpose.transform_poses_pca(poses), jpose.transform_poses_pca(poses))
    rec, _ = tpose.recenter_poses(poses[:, :3, :4])
    same(rec, jpose.recenter_poses(poses[:, :3, :4])[0])
    spiral = tpose.render_spiral_path(rec, bounds, n_frames=24)
    same(spiral, jpose.render_spiral_path(rec, bounds, n_frames=24))
    back = tpose.backcenter_poses(spiral, poses[:, :3, :4])
    same(back, jpose.backcenter_poses(spiral, poses[:, :3, :4]))
    hwf = np.tile(np.array([[[48.0], [64.0], [60.0]]]), (len(back), 1, 1))
    llff = np.concatenate([back, hwf], -1).transpose(1, 2, 0)
    same(tpose.convert_poses(llff), jpose.convert_poses(llff))
    for rvec in (rng.normal(size=3), np.zeros(3), np.array([0.0, 0.0, 3.0])):
        R = tpose._rodrigues_to_mat(rvec)
        same(R, jpose._rodrigues_to_mat(rvec))
        same(tpose._mat_to_rodrigues(R), jpose._mat_to_rodrigues(R))
    lo, hi = rng.normal(size=3), rng.normal(size=3)
    for v in (-0.5, 0.0, 0.3, 1.0, 1.5):
        same(tpose._slerp_vec(v, lo, hi), jpose._slerp_vec(v, lo, hi))


@pytest.mark.parametrize("rand,single_jitter,center", [
    (False, False, False), (False, False, True), (True, False, False), (True, True, False)])
def test_stepfun_sample_np(rand, single_jitter, center):
    rng = np.random.default_rng(5)
    t = np.sort(rng.uniform(0, 10, 9))
    w = rng.normal(size=8)
    out = []
    for mod in (tstep, jstep):
        np.random.seed(11)          # the jittered path draws from numpy's global rng
        out.append(mod.sample_np(rand, t, w, 17, single_jitter=single_jitter,
                                 deterministic_center=center))
    same(out[0], out[1])
    assert out[0].shape == (17,) and (np.diff(out[0]) >= 0).all()
    same(tstep.invert_cdf_np(np.linspace(0, 0.99, 5), t, w),
         jstep.invert_cdf_np(np.linspace(0, 0.99, 5), t, w))


# ---- readers' helpers and camera_utils -------------------------------------------

@pytest.mark.parametrize("dataset", ["LLFF", "DTU"])
def test_random_pointcloud(rng, dataset):
    xyz = rng.normal(size=(300, 3)) * [2.0, 1.0, 0.5] + [0, 0, 3]
    got = treaders._random_pointcloud(xyz, dataset, np.random.default_rng(9))
    same(got, jreaders._random_pointcloud(xyz, dataset, np.random.default_rng(9)))
    assert len(got) == (1000 if dataset == "DTU" else int((xyz.max(0) - xyz.min(0)).max() * 50))


def test_nerfpp_norm(rng):
    Rs, Ts, _ = camera_rig(rng, n=4)
    cams = [treaders.CameraInfo(uid=i, R=R, T=T, FovX=0.9, FovY=0.7, image=None,
                                image_path="", image_name=f"v{i}", width=8, height=6)
            for i, (R, T) in enumerate(zip(Rs, Ts))]
    got, ref = treaders.get_nerfpp_norm(cams), jreaders.get_nerfpp_norm(cams)
    same(got["translate"], ref["translate"])
    assert got["radius"] == ref["radius"] > 0


def test_language_features(tmp_path, rng):
    np.save(tmp_path / "v0_s.npy", rng.integers(-1, 5, (1, 12, 16)))
    np.save(tmp_path / "v0_fdim3.npy", rng.normal(size=(5, 3)))
    got = treaders.load_language_features(tmp_path, "v0", 6, 8)
    same(got, jreaders.load_language_features(tmp_path, "v0", 6, 8))
    assert got[0].shape == (6, 8, 3) and got[1].shape == (6, 8)


@pytest.mark.parametrize("shape", [(24, 32), (7, 9), (48, 64)])
def test_resizes_match(rng, shape):
    img = rng.uniform(size=(48, 64, 3)).astype(np.float32)
    same(tcu.resize_image(img, *shape), jcu.resize_image(img, *shape))
    depth = rng.uniform(1, 5, (48, 64)).astype(np.float32)
    same(tcu.resize_nearest(depth, *shape), jcu.resize_nearest(depth, *shape))
    same(tcu.resize_nearest(img, *shape), jcu.resize_nearest(img, *shape))


def test_load_camera_and_json(rng):
    R = tpose._rodrigues_to_mat(rng.normal(size=3) * 0.2)
    info = treaders.CameraInfo(
        uid=1, R=R, T=rng.normal(size=3), FovX=0.9, FovY=0.7,
        image=rng.uniform(size=(48, 64, 3)).astype(np.float32), image_path="", image_name="v",
        width=64, height=48, bounds=np.array([1.0, 9.0]),
        depth_mono=rng.uniform(1, 5, (48, 64)).astype(np.float32),
        point_feature=rng.normal(size=(48, 64, 3)).astype(np.float32),
        seg_map=rng.integers(0, 4, (48, 64)).astype(np.int32),
        feature_dict=rng.normal(size=(4, 3)).astype(np.float32))
    got, ref = tcu.load_camera(info, 2), jcu.load_camera(info, 2)
    for k in ("R", "T", "fovx", "fovy", "image", "depth_mono", "point_feature", "seg_map",
              "feature_dict", "bounds", "image_name", "width", "height"):
        same(getattr(got, k), getattr(ref, k))
    assert got.camera.view.device.type == "cpu"
    for k in ("view", "full_proj", "cam_pos"):
        same(getattr(got.camera, k).numpy(), np.asarray(getattr(ref.camera, k)))
    same(got.intrinsics(), ref.intrinsics())
    assert json.dumps(tcu.camera_to_json(3, got)) == json.dumps(jcu.camera_to_json(3, ref))
