"""The port's depth-prior pipeline (pipelines/{depth_align,fusion,mvs,
convert}.py) and eval/compare_nvs_rgbd.py against sdpgs_tpu's, on the CPU.

The numpy modules are copies of JAX's and must agree bit for bit: the
segment alignment (RANSAC draws, inheritance, the line choice), its fit
diagnostics, the batch run over a scene's PFMs, the MVS cam files and COLMAP
dense arrays (byte-equal files), COLMAP's command lines and the resized
image sets, and the depth comparator. Fusion's consistency check is torch:
its masks must equal JAX's except at pixels within 1e-5 relative of a
threshold (each such pixel is counted and printed), its reprojections agree
to 1e-4 relative, a pixel whose projection is non-finite takes XLA's
saturating index, and the fused points agree to 1e-4.
"""

import shutil
import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from sdpgs_torch.eval import compare_nvs_rgbd as tcmp
from sdpgs_torch.pipelines import convert as tconv
from sdpgs_torch.pipelines import depth_align as tda
from sdpgs_torch.pipelines import fusion as tfu
from sdpgs_torch.pipelines import mvs as tmvs
from sdpgs_tpu.data.readers import write_pfm
from sdpgs_tpu.eval import compare_nvs_rgbd as jcmp
from sdpgs_tpu.pipelines import convert as jconv
from sdpgs_tpu.pipelines import depth_align as jda
from sdpgs_tpu.pipelines import fusion as jfu
from sdpgs_tpu.pipelines import mvs as jmvs

THRESH_REL = 1e-5     # a mask may differ only this close to a threshold
POINT_TOL = 1e-4


def two_segment_case(rng, H=60, W=80, starve=False):
    """Mono depth with two (optionally three) segments of different affine
    maps to the stereo depth and 20% sparse samples; with ``starve`` a third
    segment of 1,200 px gets no samples, so it inherits a neighbour's line."""
    seg = np.zeros((H, W), np.int32)
    seg[:, 40:] = 1
    if starve:
        seg[:20, 20:80] = 2
    mono = rng.uniform(1, 5, (H, W)).astype(np.float32)
    true = np.where(seg == 0, 2.0 * mono + 1.0, 0.5 * mono + 3.0)
    sparse = np.zeros((H, W), np.float32)
    pick = (rng.random((H, W)) < 0.2) & (seg != 2)
    sparse[pick] = true[pick]
    return mono, sparse, seg


def same_npz(a, b):
    """Equal arrays under equal names (an .npz's zip entries carry their
    write time, so the files' bytes may differ)."""
    with np.load(a) as t, np.load(b) as j:
        assert t.files and sorted(t.files) == sorted(j.files)
        for k in t.files:
            assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k


def same_lines(a, b):
    assert list(a.items()) == list(b.items())


def test_scale_shift_and_ransac_bit_equal(rng):
    x = rng.uniform(1, 10, 300)
    y = 3.0 * x + 2.0
    y[:60] += rng.uniform(20, 50, 60)
    assert tda.compute_scale_and_shift(x, y) == jda.compute_scale_and_shift(x, y)
    assert tda.compute_scale_and_shift(x[:0], y[:0]) == jda.compute_scale_and_shift(x[:0], y[:0])
    for seed in (10, 3):
        assert tda.ransac_line(x, y, seed=seed) == jda.ransac_line(x, y, seed=seed)
    a, b = tda.ransac_line(x, y)
    assert a == pytest.approx(3.0, rel=0.05) and b == pytest.approx(2.0, abs=0.5)


@pytest.mark.parametrize("case", ["two_segments", "inherited", "no_sparse"])
def test_align_depth_segments_bit_equal(rng, case):
    mono, sparse, seg = two_segment_case(rng, starve=case == "inherited")
    if case == "no_sparse":
        sparse[:] = 0
    got, lines = tda.align_depth_segments(mono, sparse, seg)
    ref, jlines = jda.align_depth_segments(mono, sparse, seg)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    same_lines(lines, jlines)
    if case != "no_sparse":
        assert lines[0][0] == pytest.approx(2.0, rel=0.05)
        assert lines[1][0] == pytest.approx(0.5, rel=0.05)
    if case == "inherited":
        assert lines[2] in (lines[0], lines[1])


def test_fit_diagnostics_and_artifacts_equal(rng, tmp_path):
    mono, sparse, seg = two_segment_case(rng, starve=True)
    adjusted, lines = tda.align_depth_segments(mono, sparse, seg)
    diag, jdiag = (m.fit_diagnostics(mono, sparse, seg, lines) for m in (tda, jda))
    assert len(diag["lines"]) == len(jdiag["lines"]) == 2
    for a, b in zip(diag["lines"], jdiag["lines"]):
        assert a.keys() == b.keys()
        for k in a:
            assert np.array_equal(a[k], b[k], equal_nan=True), k
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    tda.save_fit_diagnostics(diag, mono, sparse, adjusted, seg, tmp_path / "t" / "depth_v")
    jda.save_fit_diagnostics(jdiag, mono, sparse, adjusted, seg, tmp_path / "j" / "depth_v")
    same_npz(tmp_path / "t" / "depth_v_diag.npz", tmp_path / "j" / "depth_v_diag.npz")
    for tag in ("ransac", "stereo", "adjust", "mono"):
        assert (tmp_path / "t" / f"depth_v_{tag}.jpg").exists(), tag


def write_conclude_tree(root, rng, names=("a", "b", "c")):
    """Per view: a mono PFM, a sparse stereo depth (not for the last view)
    and a segment map ([1, H, W] for the first, as the reference saves)."""
    for d in ("depth_maps_anything", "stereo_depth", "seg"):
        (root / d).mkdir(parents=True)
    for i, name in enumerate(names):
        mono, sparse, seg = two_segment_case(rng, starve=i == 1)
        write_pfm(root / "depth_maps_anything" / f"depth_{name}.pfm", 6.0 - mono)
        if i < len(names) - 1:
            np.save(root / "stereo_depth" / f"depth_{name}.npy", sparse)
        np.save(root / "seg" / f"{name}_s.npy", seg[None] if i == 0 else seg)


def test_conclude_depth_for_scene_bit_equal(rng, tmp_path):
    write_conclude_tree(tmp_path, rng)
    for mod, out in ((tda, "t_out"), (jda, "j_out")):
        mod.conclude_depth_for_scene(tmp_path, seg_dir="seg", out_dir=out, diagnostics=True)
    t_files = sorted(p.name for p in (tmp_path / "t_out").iterdir())
    assert t_files == sorted(p.name for p in (tmp_path / "j_out").iterdir())
    for name in ("a", "b", "c"):
        got = np.load(tmp_path / "t_out" / f"depth_{name}.npy")
        ref = np.load(tmp_path / "j_out" / f"depth_{name}.npy")
        assert got.dtype == ref.dtype and np.array_equal(got, ref), name
    assert "depth_a_diag.npz" in t_files and "depth_c_diag.npz" not in t_files


# -- fusion ------------------------------------------------------------------

def camera_rig(n=3):
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    Rs, ts = [], []
    for i in range(n):
        a = 0.04 * (i - 1)
        Rs.append(np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]))
        ts.append(np.array([0.15 * (i - 1), 0.02 * i, 0.0]))
    return [K] * n, Rs, ts


def wavy_depth(rng, H=48, W=64, noise=0.02):
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    d = 3.0 + 0.3 * np.sin(xs / 7.0) + 0.2 * np.cos(ys / 5.0)
    return (d + noise * rng.normal(size=(H, W))).astype(np.float32)


def near_threshold(dist, rel):
    return ((np.abs(dist - 5.0) <= THRESH_REL * 5.0)
            | (np.abs(rel - 0.2) <= THRESH_REL * 0.2))


def check_pair(d_ref, d_src, cams_ref, cams_src, label):
    """The port's consistency check against JAX's on one pair; returns the
    number of threshold pixels where the masks differ."""
    jargs = [jnp.asarray(d_ref)] + [jnp.asarray(m) for m in cams_ref] + \
            [jnp.asarray(d_src)] + [jnp.asarray(m) for m in cams_src]
    targs = [torch.from_numpy(d_ref), *cams_ref, torch.from_numpy(d_src), *cams_src]
    jrep = [np.asarray(a) for a in jfu.reproject_with_depth(*jargs)]
    trep = [a.numpy() for a in tfu.reproject_with_depth(*targs)]
    for name, a, b in zip(("depth", "x_reproj", "y_reproj", "x_src", "y_src"), trep, jrep):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, equal_nan=True,
                                   err_msg=f"{label}: {name}")
    jmask, jd = (np.asarray(a) for a in jfu.check_geometric_consistency(*jargs))
    tmask, td = (a.numpy() for a in tfu.check_geometric_consistency(*targs))
    H, W = d_ref.shape
    ys, xs = np.meshgrid(np.arange(H, dtype=np.float32), np.arange(W, dtype=np.float32),
                         indexing="ij")
    dist = np.sqrt((jrep[1] - xs) ** 2 + (jrep[2] - ys) ** 2)
    rel = np.abs(jrep[0] - d_ref) / np.maximum(d_ref, 1e-8)
    differ = tmask != jmask
    assert not (differ & ~near_threshold(dist, rel)).any(), label
    both = tmask & jmask
    np.testing.assert_allclose(td[both], jd[both], rtol=1e-4, atol=0)
    print(f"{label}: {int(jmask.sum())} consistent pixels, {int(differ.sum())} differ "
          f"(all within {THRESH_REL:g} of a threshold)")
    return int(differ.sum())


@pytest.mark.parametrize("noise", [0.02, 0.5])
def test_consistency_check_matches_jax(rng, noise):
    """Depths that agree up to small noise (most pixels consistent) and up
    to noise of the size of the thresholds (about half are)."""
    Ks, Rs, ts = camera_rig()
    depths = [wavy_depth(rng, noise=noise) for _ in range(3)]
    differ = 0
    for ref, src in ((0, 1), (1, 0), (1, 2), (0, 2)):
        differ += check_pair(depths[ref], depths[src], (Ks[ref], Rs[ref], ts[ref]),
                             (Ks[src], Rs[src], ts[src]), f"pair {ref}->{src}")
    print(f"threshold pixels whose masks differ: {differ}")


def test_consistency_check_flat_plane(rng):
    """test_pipelines.py's fronto-parallel plane through both packages."""
    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    d = np.full((48, 64), 3.0, np.float32)
    ref, src = (K, np.eye(3), np.zeros(3)), (K, np.eye(3), np.array([0.2, 0.0, 0.0]))
    check_pair(d, d, ref, src, "flat plane")
    mask, dep = tfu.check_geometric_consistency(torch.from_numpy(d), *ref,
                                                torch.from_numpy(d), *src)
    assert float(mask.float().mean()) > 0.8
    np.testing.assert_allclose(dep.numpy()[mask.numpy()], 3.0, atol=1e-3)


def test_non_finite_projection_takes_xla_index():
    """A pixel whose point lies in the source camera's plane (z = 0)
    projects to +-inf, or NaN where the numerator is 0 too: the sample
    index must be XLA's saturating conversion, clipped."""
    x = np.array([np.nan, np.inf, -np.inf, 3e9, -3e9, 2.5, 3.5, -0.5, 62.5, 63.7, 1e30],
                 np.float32)
    ref = np.asarray(jnp.clip(jnp.round(jnp.asarray(x)).astype(jnp.int32), 0, 63))
    got = tfu._pixel_index(torch.from_numpy(x), 63).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, ref), (got, ref)

    K = np.array([[50.0, 0, 32], [0, 50.0, 24], [0, 0, 1]])
    d_ref = np.full((48, 64), 2.0, np.float32)
    d_ref[24, 32] = 3.0      # on the principal ray: 0 / 0 in the source
    d_ref[5, 10] = 3.0       # off it: +-inf
    d_src = np.linspace(1.0, 4.0, 48 * 64, dtype=np.float32).reshape(48, 64)
    cams_ref = (K, np.eye(3), np.zeros(3))
    cams_src = (K, np.eye(3), np.array([0.0, 0.0, -3.0]))
    xs = tfu.reproject_with_depth(torch.from_numpy(d_ref), *cams_ref,
                                  torch.from_numpy(d_src), *cams_src)[3].numpy()
    assert np.isnan(xs[24, 32]) and np.isinf(xs[5, 10])
    check_pair(d_ref, d_src, cams_ref, cams_src, "source plane")


def test_fuse_depths_matches_jax(rng):
    Ks, Rs, ts = camera_rig()
    true = [wavy_depth(rng, noise=0.0) for _ in range(3)]
    mono = [((t - 1.0) / 2.0 + 0.15 * rng.normal(size=t.shape)).astype(np.float32) for t in true]
    sparse = [t * (rng.random(t.shape) < 0.3) for t in true]
    colors = [rng.uniform(size=t.shape + (3,)).astype(np.float32) for t in true]
    for kw in (dict(), dict(colors=colors, min_consistent=2, downsample_to=2000)):
        pts, cols = tfu.fuse_depths(mono, sparse, Ks, Rs, ts, device="cpu", **kw)
        jpts, jcols = jfu.fuse_depths(mono, sparse, Ks, Rs, ts, **kw)
        assert pts.shape == jpts.shape and 1000 < len(pts) < 3 * 48 * 64, pts.shape
        np.testing.assert_allclose(pts, jpts, rtol=POINT_TOL, atol=POINT_TOL)
        np.testing.assert_array_equal(cols, jcols)
    assert np.abs(pts[:, 2].mean() - 3.0) < 0.3


def test_fuse_depths_needs_a_device_or_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tfu.fuse_depths([np.ones((4, 4), np.float32)] * 2, [np.zeros((4, 4))] * 2,
                        [np.eye(3)] * 2, [np.eye(3)] * 2, [np.zeros(3)] * 2)


def test_voxel_downsample_equal(rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.uniform(size=(500, 3)).astype(np.float32)
    for got, ref in zip(tfu.voxel_downsample(pts, cols, 0.5), jfu.voxel_downsample(pts, cols, 0.5)):
        assert got.dtype == ref.dtype and np.array_equal(got, ref)


# -- MVS interchange and the COLMAP runner ---------------------------------------

def write_tracked_model(sparse, rng, n_views=4, n_pts=60):
    """A COLMAP binary model whose images observe the points (points2D with
    3D ids, some -1), so the cam files' depth ranges come from tracks."""
    sparse.mkdir(parents=True)
    W, H = 64, 48
    with open(sparse / "cameras.bin", "wb") as f:
        f.write(struct.pack("<Q", 2))
        f.write(struct.pack("<iiQQ", 1, 1, W, H) + struct.pack("<dddd", 60.0, 55.0, 32, 24))
        f.write(struct.pack("<iiQQ", 2, 0, W, H) + struct.pack("<ddd", 58.0, 31, 23))
    xyz = rng.normal(size=(n_pts, 3)) + [0, 0, 4]
    with open(sparse / "images.bin", "wb") as f:
        f.write(struct.pack("<Q", n_views))
        for i in range(n_views):
            q = np.array([1.0, 0.01 * i, -0.02 * i, 0.0])
            q /= np.linalg.norm(q)
            f.write(struct.pack("<i4d3di", i + 1, *q, 0.1 * i, 0.0, 0.05 * i, 1 + i % 2))
            f.write(f"view{i:02d}.png".encode() + b"\x00")
            ids = rng.choice(n_pts, 20, replace=False).astype(np.int64)
            ids[:3] = -1
            f.write(struct.pack("<Q", len(ids)))
            for pid in ids:
                f.write(struct.pack("<ddq", *rng.uniform(0, 40, 2), int(pid)))
    with open(sparse / "points3D.bin", "wb") as f:
        f.write(struct.pack("<Q", n_pts))
        for pid in range(n_pts):
            f.write(struct.pack("<Q", pid) + struct.pack("<ddd", *xyz[pid]))
            f.write(struct.pack("<BBB", 10, 20, 30) + struct.pack("<d", 0.4))
            f.write(struct.pack("<Q", 1) + struct.pack("<ii", 1, 0))


def same_tree(a, b):
    files = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    assert files and files == sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f


def test_mvs_cams_byte_equal(rng, tmp_path):
    write_tracked_model(tmp_path / "sparse", rng)
    tmvs.write_mvs_cams(tmp_path / "sparse", tmp_path / "t_cams")
    jmvs.write_mvs_cams(tmp_path / "sparse", tmp_path / "j_cams")
    same_tree(tmp_path / "t_cams", tmp_path / "j_cams")
    assert len(list((tmp_path / "t_cams").iterdir())) == 4


def test_colmap_arrays_and_dense_depths_byte_equal(rng, tmp_path):
    dense = tmp_path / "stereo"
    dense.mkdir()
    depth = rng.uniform(0.5, 8.0, (24, 32)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.2] = 0
    normal = rng.normal(size=(24, 32, 3)).astype(np.float32)
    for mod, tag in ((tmvs, "t"), (jmvs, "j")):
        mod.write_colmap_array(dense / f"{tag}.png.geometric.bin", depth)
        mod.write_colmap_array(dense / f"{tag}n.png.normal.bin", normal)
    assert (dense / "t.png.geometric.bin").read_bytes() == \
        (dense / "j.png.geometric.bin").read_bytes()
    assert (dense / "tn.png.normal.bin").read_bytes() == \
        (dense / "jn.png.normal.bin").read_bytes()
    for f in ("t.png.geometric.bin", "tn.png.normal.bin"):
        got, ref = tmvs.read_colmap_array(dense / f), jmvs.read_colmap_array(dense / f)
        assert np.array_equal(got, ref)
    assert np.array_equal(tmvs.read_colmap_array(dense / "t.png.geometric.bin"), depth)
    tmvs.extract_dense_depths(dense, tmp_path / "t_out")
    jmvs.extract_dense_depths(dense, tmp_path / "j_out")
    same_tree(tmp_path / "t_out", tmp_path / "j_out")


def convert_tree(root, rng):
    for d in ("input", "images", "sparse"):
        (root / d).mkdir(parents=True)
    for i in range(2):
        img = (rng.uniform(size=(40, 56, 3)) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "input" / f"im{i}.jpg")
        Image.fromarray(img).save(root / "images" / f"im{i}.png")
    (root / "images" / "notes.txt").write_text("not an image")
    (root / "sparse" / "cameras.bin").write_bytes(b"\x00" * 8)


def test_convert_commands_and_resized_sets(rng, tmp_path, monkeypatch):
    ran = {"t": [], "j": []}
    monkeypatch.setattr(tconv, "_run", lambda cmd: ran["t"].append(cmd))
    monkeypatch.setattr(jconv, "_run", lambda cmd: ran["j"].append(cmd))
    convert_tree(tmp_path / "t", rng)
    shutil.copytree(tmp_path / "t", tmp_path / "j")
    tconv.convert_scene(tmp_path / "t", colmap_executable="colmap-3.9", use_gpu=True,
                        min_num_matches=7)
    jconv.convert_scene(tmp_path / "j", colmap_executable="colmap-3.9", use_gpu=True,
                        min_num_matches=7)
    assert [c[1] for c in ran["t"]] == ["feature_extractor", "exhaustive_matcher", "mapper",
                                         "image_undistorter"]
    assert ran["t"] == [[a.replace(str(tmp_path / "j"), str(tmp_path / "t")) for a in c]
                        for c in ran["j"]]
    same_tree(tmp_path / "t", tmp_path / "j")
    assert (tmp_path / "t" / "sparse" / "0" / "cameras.bin").exists()
    assert Image.open(tmp_path / "t" / "images_4" / "im0.png").size == (14, 10)


def test_compare_nvs_rgbd_bit_equal(rng, tmp_path):
    sensor = rng.uniform(0, 4000, (48, 64)).astype(np.float32)
    sensor[rng.random(sensor.shape) < 0.1] = 0
    mono = rng.uniform(0, 255, (24, 32)).astype(np.float32)
    got, ref = tcmp.compare_depth(sensor, mono), jcmp.compare_depth(sensor, mono)
    assert got.keys() == ref.keys()
    for k in got:
        assert np.array_equal(got[k], ref[k]), k
    for split in ("iphone", "kinect"):
        for d in ("depth", "depth_maps"):
            (tmp_path / split / d).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 5000, (48, 64)).astype(np.uint16)).save(
                tmp_path / split / "depth" / f"{i}.png")
            Image.fromarray(rng.integers(0, 255, (24, 32)).astype(np.uint8)).save(
                tmp_path / split / "depth_maps" / f"depth_{i}.png")
    t_written = tcmp.compare_scene(tmp_path, out_dir="t_cmp")
    j_written = jcmp.compare_scene(tmp_path, out_dir="j_cmp")
    assert len(t_written) == len(j_written) == 4
    for t, j in zip(t_written, j_written):
        same_npz(t, j)
