"""Build, load and count the hand-written CUDA kernels of ``csrc/``.

The kernels are compiled at first use with ``nvcc`` for ``sm_90a`` (one
process per source, all started together, then linked into one shared
library with a plain C interface) and loaded with ``ctypes``. The build
goes to ``build/kernels/`` inside the package, under a name that hashes
the sources and flags, so an edit rebuilds. Nothing here runs at import:
a host without ``nvcc`` imports the package and uses the plain PyTorch
versions for CPU tensors.

Every wrapper adds one to ``LAUNCHES[name]`` where it launches its kernel,
and every plain version adds one to ``PLAIN_CALLS[name]``, so a run can
show which path it took. K1-K3 (``FORWARD_KERNELS``) run on every render;
K4 and K5 (``BACKWARD_KERNELS``) run in the backward of a train step; K6
(``WARP_KERNELS``) builds the reprojection z-buffers of the pseudo-view
branch. K7 (``SORT_KERNELS``, the stable depth sort of ``ops/sort.py``)
and K8 (``PROBE_KERNELS``, the launch-floor probe of
``ops/launch_floor.py``) each serve their own entry point and lie on no
render or train path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build" / "kernels"
NVCC_DEFAULT = Path("/usr/local/cuda/bin/nvcc")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMMON = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
# Per-source flags. K1's culling and radius, and the masks K4's gradient
# passes through, are step functions of float math: no FMA contraction,
# so both round exactly as the plain version does.
SOURCES = {
    "preprocess.cu": ["-fmad=false"],
    "binning.cu": [],
    "composite.cu": [],
    "preprocess_bwd.cu": ["-fmad=false"],
    "composite_bwd.cu": [],
    # K6's u, v and z round exactly as its plain version's do
    "warp_zbuf.cu": ["-fmad=false"],
    "sort.cu": [],
    "launch_floor.cu": [],
}
FORWARD_KERNELS = ("preprocess", "binning", "composite")
BACKWARD_KERNELS = ("preprocess_bwd", "composite_bwd")
WARP_KERNELS = ("warp_zbuf",)
SORT_KERNELS = ("sort",)
PROBE_KERNELS = ("launch_floor",)
KERNELS = FORWARD_KERNELS + BACKWARD_KERNELS + WARP_KERNELS + SORT_KERNELS + PROBE_KERNELS

LAUNCHES = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS = dict.fromkeys(KERNELS, 0)
# K6's launches by path (ops/warp.py:zbuf_plan), beside LAUNCHES["warp_zbuf"]
WARP_PATH_LAUNCHES = {"cluster": 0, "general": 0}
BUILD_LOG = ""

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    # geo, sh, cam(host [39]), out, P, deg, width, height, near, low_pass, stream
    "sdpgs_preprocess_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # packed_s, order, n_valid(dev), table, totals, cover(scratch), P, n_local,
    # t0, tiles_x, K, D, stream
    "sdpgs_bin_table": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # P -> u32 words of K2's scratch per tile
    "sdpgs_bin_table_scratch_words": [_I],
    # payload, table, counts, values, final_t, n_visit, last_contrib, P,
    # num_tiles (rows), t0, grid_tiles, tiles_x, tile, K, alpha_min, alpha_max,
    # t_min, stream
    "sdpgs_composite_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _F, _F,
                            _F, _P],
    # the same with stats (or null) after last_contrib
    "sdpgs_composite_fwd_stats": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                  _F, _F, _F, _P],
    # geo, sh, ct, cam(host [39]), dgeo, dsh, masks(or null), P, deg, width,
    # height, near, low_pass, stream
    "sdpgs_preprocess_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _F, _P],
    # payload, table, rects, final_t, last_contrib, g_values, g_final_t,
    # d_payload, stats(or null), map, partial, tops (scratch), P, num_tiles
    # (rows), t0, grid_tiles, tiles_x, tile, K, D, alpha_min, alpha_max, stream
    "sdpgs_composite_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                            _I, _I, _I, _F, _F, _P],
    # depths, pc, out, n_pairs, V, H, W, cluster (0: the general path), rows,
    # stream
    "sdpgs_warp_zbuf": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # cluster, rows, W -> clusters resident at once (or -error)
    "sdpgs_warp_zbuf_clusters": [_I, _I, _I],
    # key, val, gid, key_out, val_out, gid_out, key_tmp, val_tmp, gid_tmp,
    # scratch, n, stream
    "sdpgs_sort_by_key": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    # n -> int32 words of scratch
    "sdpgs_sort_scratch_words": [_I],
    # packed, gid, tid, out, P, D, stream
    "sdpgs_launch_floor": [_P, _P, _P, _P, _I, _I, _P],
}
_lib = None


def reset_counts() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    for k in WARP_PATH_LAUNCHES:
        WARP_PATH_LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    if NVCC_DEFAULT.exists():
        return str(NVCC_DEFAULT)
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(repr((ARCH, COMMON, SOURCES)).encode())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile csrc/ into one shared library (cached by content hash)."""
    global BUILD_LOG
    so = BUILD_DIR / f"libsdpgs_kernels_{_digest()}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp_{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    procs = []
    for src, flags in SOURCES.items():
        obj = tmp / (src + ".o")
        cmd = [nvcc, *ARCH, *COMMON, *flags, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {src}:\n{out}")
        objs.append(str(obj))
    if failed:
        raise RuntimeError("\n".join(failed))
    part = tmp / so.name
    link = subprocess.run([nvcc, *ARCH, "-shared", "-o", str(part), *objs],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    os.replace(part, so)
    shutil.rmtree(tmp, ignore_errors=True)
    BUILD_LOG = "\n".join(log)
    return so


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        so = build()
        cdll = ctypes.CDLL(str(so))
        for name, args in _SIGNATURES.items():
            fn = getattr(cdll, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int
        cdll.sdpgs_error_string.argtypes = [ctypes.c_int]
        cdll.sdpgs_error_string.restype = ctypes.c_char_p
        _lib = cdll
    return _lib


def build_seconds() -> float:
    """Build (or load) the library and return the seconds it took."""
    t0 = time.perf_counter()
    lib()
    return time.perf_counter() - t0


def launch(kernel: str, fn: str, *args) -> None:
    """Call the C launcher ``fn`` and count the launch; raise on a CUDA error."""
    err = getattr(lib(), fn)(*args)
    if err != 0:
        msg = lib().sdpgs_error_string(err).decode()
        raise RuntimeError(f"{fn}: CUDA error {err}: {msg}")
    LAUNCHES[kernel] += 1


def plain_call(kernel: str) -> None:
    PLAIN_CALLS[kernel] += 1


def stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    """A tensor's device address; ``None`` passes a null pointer."""
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """What a kernel takes: a contiguous CUDA tensor of this dtype and shape
    that autograd does not track (a launcher sits inside the
    ``autograd.Function`` that owns its gradient and is handed detached
    tensors)."""
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if t.requires_grad:
        raise ValueError(f"{name}: a kernel launcher takes no tensor that requires "
                         "grad; call it through its autograd.Function")
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
