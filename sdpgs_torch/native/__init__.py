"""ctypes binding to the repo's native I/O and geometry library
(``native/sdpgs_io.cc``): the points3D.bin parser with tracks, the voxel
downsample and 4-connected components.

Counterpart of ``sdpgs_tpu/native/__init__.py``. The source is used as it
is: at first use ``g++`` builds it into ``sdpgs_torch/build/native/`` under
a name that hashes the source and the flags, and nothing is written into
``native/``. The flags name no host CPU (no ``-march=native``), so a
library built on one x86-64 machine loads on another; one that fails to
load is rebuilt. ``BUILD_LOG`` says what was built or loaded and why it
failed. Where the library cannot be built, each function falls back to the
port's Python version (``pipelines/fusion.voxel_downsample``,
``pipelines/depth_align._connected_components``, ``data/colmap``), as the
JAX package does; ``available()`` says which ran.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "sdpgs_io.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "native"
FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]
BUILD_LOG = ""
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(repr(FLAGS).encode())
    return BUILD_DIR / f"libsdpgs_io_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """Compile the source into ``so`` (through a private file, then an
    atomic rename, so concurrent builds never load a partial library)."""
    global BUILD_LOG
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    part = so.with_name(f"{so.stem}.{os.getpid()}.tmp")
    res = subprocess.run([cxx, *FLAGS, "-o", str(part), str(SOURCE)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if res.returncode != 0:
        part.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {SOURCE.name}:\n{res.stdout}")
    os.replace(part, so)
    BUILD_LOG += f"built {so.name} with {Path(cxx).name} {' '.join(FLAGS)}\n"


def _bind(so: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(so))
    c = ctypes.c_longlong
    dp = np.ctypeslib.ndpointer(np.float64, flags="C")
    fp = np.ctypeslib.ndpointer(np.float32, flags="C")
    ip = np.ctypeslib.ndpointer(np.int32, flags="C")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
    lib.colmap_points3d_count.restype = c
    lib.colmap_points3d_count.argtypes = [ctypes.c_char_p]
    lib.colmap_points3d_parse.restype = c
    lib.colmap_points3d_parse.argtypes = [
        ctypes.c_char_p, dp, dp, dp, c, ctypes.c_void_p, c, ctypes.c_void_p
    ]
    lib.voxel_downsample.restype = c
    lib.voxel_downsample.argtypes = [fp, fp, c, ctypes.c_float, fp, fp]
    lib.connected_components.restype = ctypes.c_int
    lib.connected_components.argtypes = [u8p, ctypes.c_int, ctypes.c_int, ip]
    return lib


def _load() -> Optional[ctypes.CDLL]:
    """The bound library, built at first use; None (recorded in
    ``BUILD_LOG``) when it can be neither loaded nor built."""
    global _lib, _tried, BUILD_LOG
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        so = _library_path()
        if so.exists():
            try:
                _lib = _bind(so)
                BUILD_LOG += f"loaded {so.name}\n"
                return _lib
            except OSError as e:      # built for another machine: rebuild
                BUILD_LOG += f"could not load {so.name} ({e}); rebuilding\n"
        _build(so)
        _lib = _bind(so)
    except (OSError, RuntimeError) as e:
        BUILD_LOG += f"native library unavailable: {e}\n"
        _lib = None
    return _lib


def available() -> bool:
    return _load() is not None


def read_points3d(path, with_tracks: bool = False):
    """points3D.bin -> (xyz, rgb, err[, obs]), obs [M, 3] rows of
    (point index, image id, keypoint index). Without the library the Python
    parser reads it; tracks need the library."""
    lib = _load()
    if lib is None:
        from sdpgs_torch.data import colmap

        if with_tracks:
            raise RuntimeError("track parsing requires the native library")
        return colmap.read_points3D_binary(path)

    n = lib.colmap_points3d_count(str(path).encode())
    if n < 0:
        raise IOError(f"cannot read {path}")
    xyz = np.empty((n, 3), np.float64)
    rgb = np.empty((n, 3), np.float64)
    err = np.empty((n,), np.float64)
    if with_tracks:
        max_obs = max(n * 8, 1)
        obs = np.empty((max_obs, 3), np.int64)
        n_obs = np.zeros((1,), np.int64)
        got = lib.colmap_points3d_parse(
            str(path).encode(), xyz, rgb, err, n,
            obs.ctypes.data_as(ctypes.c_void_p), max_obs,
            n_obs.ctypes.data_as(ctypes.c_void_p),
        )
        if got != n:
            raise IOError(f"{path}: parsed {got} of {n} points")
        return xyz, rgb, err, obs[: int(n_obs[0])]
    got = lib.colmap_points3d_parse(str(path).encode(), xyz, rgb, err, n, None, 0, None)
    if got != n:
        raise IOError(f"{path}: parsed {got} of {n} points")
    return xyz, rgb, err


def voxel_downsample(points: np.ndarray, colors: np.ndarray, voxel: float
                     ) -> Tuple[np.ndarray, np.ndarray]:
    lib = _load()
    if lib is None:
        from sdpgs_torch.pipelines.fusion import voxel_downsample as py_vd

        return py_vd(points, colors, voxel)
    pts = np.ascontiguousarray(points, np.float32)
    cols = np.ascontiguousarray(colors, np.float32)
    out_p = np.empty_like(pts)
    out_c = np.empty_like(cols)
    m = lib.voxel_downsample(pts, cols, len(pts), voxel, out_p, out_c)
    return out_p[:m].copy(), out_c[:m].copy()


def connected_components(mask: np.ndarray) -> Tuple[np.ndarray, int]:
    lib = _load()
    if lib is None:
        from sdpgs_torch.pipelines.depth_align import _connected_components

        return _connected_components(mask)
    m = np.ascontiguousarray(mask.astype(np.uint8))
    labels = np.empty(m.shape, np.int32)
    n = lib.connected_components(m, m.shape[0], m.shape[1], labels)
    return labels, n
