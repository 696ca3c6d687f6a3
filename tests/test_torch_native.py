"""The port's binding to native/sdpgs_io.cc (sdpgs_torch/native) on the
CPU: it builds the unedited source with g++ into sdpgs_torch/build/native/
(never into native/), and its three entry points agree with the port's
Python versions and with the JAX package's binding (test_native.py's four
cases). A library that no longer loads is rebuilt; one that cannot be built
leaves the Python versions in charge, and ``available()`` says so."""

import numpy as np
import pytest

from sdpgs_torch import native as tnative
from sdpgs_torch.data import colmap as tcolmap
from sdpgs_torch.pipelines.depth_align import _connected_components
from sdpgs_torch.pipelines.fusion import voxel_downsample as py_voxel
from sdpgs_tpu import native as jnative
from test_native import _write_points3d


@pytest.fixture(scope="module")
def built():
    assert tnative.available(), tnative.BUILD_LOG
    so = tnative._library_path()
    assert so.exists() and so.parent == tnative.BUILD_DIR
    assert so.parent.parts[-3:] == ("sdpgs_torch", "build", "native")
    return so


def test_points3d_matches_python_and_jax(tmp_path, built):
    path = tmp_path / "points3D.bin"
    xyz = _write_points3d(path)
    got = tnative.read_points3d(path)
    for a, b, c in zip(got, tcolmap.read_points3D_binary(path), jnative.read_points3d(path)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    np.testing.assert_array_equal(got[0], xyz)


def test_points3d_tracks(tmp_path, built):
    path = tmp_path / "points3D.bin"
    _write_points3d(path)
    xyz, rgb, err, obs = tnative.read_points3d(path, with_tracks=True)
    expect = sum(p % 3 for p in range(50))
    assert obs.shape == (expect, 3) and obs[:, 1].min() >= 1
    np.testing.assert_array_equal(obs, jnative.read_points3d(path, with_tracks=True)[3])


def test_voxel_downsample(built, rng):
    pts = rng.normal(size=(500, 3)).astype(np.float32)
    cols = rng.uniform(size=(500, 3)).astype(np.float32)
    na_p, na_c = tnative.voxel_downsample(pts, cols, 0.5)
    np_p, np_c = py_voxel(pts, cols, 0.5)
    assert len(na_p) == len(np_p)
    np.testing.assert_allclose(np.sort(na_p, axis=0), np.sort(np_p, axis=0), atol=1e-5)
    np.testing.assert_allclose(np.sort(na_c, axis=0), np.sort(np_c, axis=0), atol=1e-5)
    for a, b in zip((na_p, na_c), jnative.voxel_downsample(pts, cols, 0.5)):
        np.testing.assert_array_equal(a, b)


def test_connected_components(built):
    mask = np.zeros((20, 30), bool)
    mask[2:5, 2:6] = True
    mask[10:15, 10:20] = True
    mask[0, 29] = True
    labels, n = tnative.connected_components(mask)
    labels_p, n_p = _connected_components(mask)
    assert n == n_p == 3
    np.testing.assert_array_equal(labels, labels_p)
    np.testing.assert_array_equal(labels, jnative.connected_components(mask)[0])


def test_unloadable_library_is_rebuilt(built, tmp_path, monkeypatch):
    """A cached library that fails to load (built for another machine) is
    rebuilt in place, and BUILD_LOG says so."""
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "BUILD_LOG", "")
    so = tnative._library_path()
    so.parent.mkdir(parents=True)
    so.write_bytes(b"not an ELF file")
    assert tnative.available()
    assert "rebuilding" in tnative.BUILD_LOG and f"built {so.name}" in tnative.BUILD_LOG
    assert tnative.connected_components(np.ones((3, 3), bool))[1] == 1


def test_without_compiler_python_versions_run(tmp_path, monkeypatch, rng):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_tried", False)
    monkeypatch.setattr(tnative, "BUILD_LOG", "")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available()
    assert "no C++ compiler" in tnative.BUILD_LOG
    mask = rng.random((12, 9)) < 0.5
    np.testing.assert_array_equal(tnative.connected_components(mask)[0],
                                  _connected_components(mask)[0])
    with pytest.raises(RuntimeError, match="native library"):
        tnative.read_points3d(tmp_path / "points3D.bin", with_tracks=True)
