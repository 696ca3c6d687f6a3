"""Self-contained binary PLY I/O (no plyfile dependency).

Counterpart of ``sdpgs_tpu/data/ply.py``, with the same Gaussian attribute
layout as the reference (gaussian_model.py:286-325: x,y,z, nx,ny,nz,
f_dc_*, f_rest_*, opacity, scale_*, rot_*, languagefeature_*), so a PLY
written by either package loads in the other.
"""

from __future__ import annotations

import io
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "float": "f4", "double": "f8",
    "float32": "f4", "float64": "f8", "int32": "i4", "uint8": "u1",
}


def write_ply(path, props: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY with one 'vertex' element."""
    names = list(props)
    n = len(next(iter(props.values())))
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}"]
    dtype = []
    for name in names:
        arr = np.asarray(props[name])
        if arr.shape[0] != n:
            raise ValueError(f"property {name} has {arr.shape[0]} rows, expected {n}")
        kind = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}[
            arr.dtype.str[1:]
        ]
        header.append(f"property {kind} {name}")
        dtype.append((name, arr.dtype.str))
    header.append("end_header")
    rec = np.empty(n, dtype=dtype)
    for name in names:
        rec[name] = props[name]
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())


def read_ply(path) -> Dict[str, np.ndarray]:
    """Read a PLY 'vertex' element (binary LE or ascii) into a dict."""
    data = Path(path).read_bytes()
    end = data.find(b"end_header")
    header = data[:end].decode("ascii", errors="replace").splitlines()
    body = data[end + len(b"end_header") :]
    body = body[body.find(b"\n") + 1 :]

    fmt = "binary_little_endian"
    n = 0
    dtype: List[Tuple[str, str]] = []
    in_vertex = False
    for line in header:
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            fmt = parts[1]
        elif parts[0] == "element":
            in_vertex = parts[1] == "vertex"
            if in_vertex:
                n = int(parts[2])
        elif parts[0] == "property" and in_vertex:
            if parts[1] == "list":
                raise ValueError("list properties unsupported")
            dtype.append((parts[2], "<" + _PLY_DTYPES[parts[1]]))

    if fmt == "ascii":
        rows = np.loadtxt(io.BytesIO(body), max_rows=n, ndmin=2)
        return {name: rows[:, i].astype(dt) for i, (name, dt) in enumerate(dtype)}
    rec = np.frombuffer(body, dtype=dtype, count=n)
    return {name: np.ascontiguousarray(rec[name]) for name, _ in dtype}


def read_pointcloud_ply(path) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(points [N,3], colors [N,3] in [0,1], normals [N,3]); the reference's
    ``fetchPly`` (dataset_readers.py)."""
    p = read_ply(path)
    pts = np.stack([p["x"], p["y"], p["z"]], axis=-1).astype(np.float32)
    if "red" in p:
        cols = np.stack([p["red"], p["green"], p["blue"]], axis=-1).astype(np.float32)
        if cols.max() > 1.5:
            cols = cols / 255.0
    else:
        cols = np.full_like(pts, 0.5)
    if "nx" in p:
        normals = np.stack([p["nx"], p["ny"], p["nz"]], axis=-1).astype(np.float32)
    else:
        normals = np.zeros_like(pts)
    return pts, cols, normals


def write_pointcloud_ply(path, points, colors=None, normals=None) -> None:
    """x, y, z, nx, ny, nz and, with ``colors`` in [0, 1], uchar red, green,
    blue: the layout :func:`read_pointcloud_ply` reads."""
    points = np.asarray(points, np.float32)
    props = {"x": points[:, 0], "y": points[:, 1], "z": points[:, 2]}
    if normals is None:
        normals = np.zeros_like(points)
    props.update(nx=normals[:, 0].astype(np.float32),
                 ny=normals[:, 1].astype(np.float32),
                 nz=normals[:, 2].astype(np.float32))
    if colors is not None:
        cols = (np.clip(np.asarray(colors), 0, 1) * 255).astype(np.uint8)
        props.update(red=cols[:, 0], green=cols[:, 1], blue=cols[:, 2])
    write_ply(path, props)


def save_gaussians_ply(path, g, include_feature: bool = True) -> None:
    """reference gaussian_model.py:303-325 attribute layout. Only alive
    slots are exported (the reference has no dead slots)."""
    a = g.to_numpy()
    alive = a["alive"] > 0
    xyz = a["xyz"][alive]
    n = xyz.shape[0]
    props: Dict[str, np.ndarray] = {
        "x": xyz[:, 0], "y": xyz[:, 1], "z": xyz[:, 2],
        "nx": np.zeros(n, np.float32), "ny": np.zeros(n, np.float32),
        "nz": np.zeros(n, np.float32),
    }
    # channel-major flatten (reference transposes [P, K, 3] -> [P, 3, K])
    dc = a["features_dc"][alive].transpose(0, 2, 1).reshape(n, -1)
    for i in range(dc.shape[1]):
        props[f"f_dc_{i}"] = dc[:, i]
    rest = a["features_rest"][alive].transpose(0, 2, 1).reshape(n, -1)
    for i in range(rest.shape[1]):
        props[f"f_rest_{i}"] = rest[:, i]
    props["opacity"] = a["opacity"][alive][:, 0]
    for name, field in (("scale", "scaling"), ("rot", "rotation")):
        arr = a[field][alive]
        for i in range(arr.shape[1]):
            props[f"{name}_{i}"] = arr[:, i]
    if include_feature:
        lf = a["language_feature"][alive]
        for i in range(lf.shape[1]):
            props[f"languagefeature_{i}"] = lf[:, i]
    write_ply(path, {k: np.asarray(v, np.float32) for k, v in props.items()})


def _stack_numbered(p, prefix):
    names = sorted((k for k in p if k.startswith(prefix)),
                   key=lambda s: int(s.split("_")[-1]))
    return names, (np.stack([p[k] for k in names], axis=-1) if names else None)


def load_gaussians_ply(path, capacity: int, max_sh_degree: int = 3, device=None):
    """reference gaussian_model.py:357-398 -> static-capacity Gaussians on
    ``device`` (``cuda`` unless the caller asks for another)."""
    from sdpgs_torch import default_device
    from sdpgs_torch.core.gaussians import Gaussians

    dev = default_device(device)
    p = read_ply(path)
    n = len(p["x"])
    if n > capacity:
        raise ValueError(f"PLY has {n} gaussians > capacity {capacity}")
    K = (max_sh_degree + 1) ** 2

    xyz = np.stack([p["x"], p["y"], p["z"]], axis=-1)
    f_dc = np.stack([p[f"f_dc_{i}"] for i in range(3)], axis=-1)[:, None, :]
    rest_names, f_rest = _stack_numbered(p, "f_rest_")
    if len(rest_names) != 3 * (K - 1):
        raise ValueError(f"PLY has {len(rest_names)} f_rest_* properties, SH degree "
                         f"{max_sh_degree} needs {3 * (K - 1)}")
    # stored channel-major [3, K-1] -> [K-1, 3]
    f_rest = (np.zeros((n, 0), np.float32) if f_rest is None else f_rest)
    f_rest = f_rest.reshape(n, 3, K - 1).transpose(0, 2, 1)
    _, scaling = _stack_numbered(p, "scale_")
    _, rotation = _stack_numbered(p, "rot_")
    _, lf = _stack_numbered(p, "languagefeature_")
    if lf is None:
        lf = np.zeros((n, 3), np.float32)

    def pad(a, fill=0.0):
        out = np.full((capacity,) + a.shape[1:], fill, np.float32)
        out[:n] = a
        return out

    rot_pad = np.zeros((capacity, 4), np.float32)
    rot_pad[:, 0] = 1.0
    rot_pad[:n] = rotation
    alive = np.zeros(capacity, np.float32)
    alive[:n] = 1.0
    return Gaussians.from_numpy(dict(
        xyz=pad(xyz),
        features_dc=pad(f_dc),
        features_rest=pad(f_rest),
        scaling=pad(scaling, fill=-10.0),
        rotation=rot_pad,
        opacity=pad(p["opacity"][:, None], fill=-10.0),
        language_feature=pad(lf),
        alive=alive,
        confidence=pad(np.ones((n, 1), np.float32), fill=1.0),
    ), max_sh_degree=max_sh_degree, device=dev)
