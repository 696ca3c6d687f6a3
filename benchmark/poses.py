"""Camera paths of the LLFF protocol, in numpy.

Copied from ``sdpgs_torch/data/pose_sampling.py``: the pseudo cameras of
the pseudo-view loss (``generate_random_poses_llff``, the reference's
pose_utils.py:262-308) and the render CLI's spiral path
(``generate_spiral_path``, 180 frames). Poses are [N, 4, 4] world to
camera.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position):
    """Camera-to-world 3x4 from look direction (reference pose_utils.py:15-21)."""
    vec2 = normalize(lookdir)
    vec0 = normalize(np.cross(up, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, position], axis=1)


def pad_poses(p):
    bottom = np.broadcast_to([0, 0, 0, 1.0], p[..., :1, :4].shape)
    return np.concatenate([p[..., :3, :4], bottom], axis=-2)


def unpad_poses(p):
    return p[..., :3, :4]


def poses_avg(poses):
    position = poses[:, :3, 3].mean(0)
    z_axis = poses[:, :3, 2].mean(0)
    up = poses[:, :3, 1].mean(0)
    return viewmatrix(z_axis, up, position)


def recenter_poses(poses):
    cam2world = poses_avg(poses)
    transform = np.linalg.inv(pad_poses(cam2world[None]))[0]
    poses = transform @ pad_poses(poses)
    return unpad_poses(poses), transform


def _c2w_from_camera(R: np.ndarray, T: np.ndarray) -> np.ndarray:
    """Camera (R=C2W rotation, T=W2C translation) -> OpenGL-style C2W with
    flipped y/z (reference pose_utils.py:266-271)."""
    w2c = np.eye(4)
    w2c[:3] = np.concatenate([R.T, T[:, None]], 1)
    c2w = np.linalg.inv(w2c)
    c2w[:, 1:3] *= -1
    return c2w


def generate_random_poses_llff(
    Rs: Sequence[np.ndarray],
    Ts: Sequence[np.ndarray],
    bounds: np.ndarray,
    n_poses: int = 10000,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """reference pose_utils.py:262-308. Returns [N, 4, 4] W2C."""
    rng = rng or np.random.default_rng(0)
    poses = np.stack([_c2w_from_camera(R, T) for R, T in zip(Rs, Ts)], 0)
    bounds = np.asarray(bounds, np.float64)

    scale = 1.0 / (bounds.min() * 0.75)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale
    poses3, transform = recenter_poses(poses[:, :3, :4])

    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1 - dt) / close_depth + dt / inf_depth)

    positions = poses3[:, :3, 3]
    radii = np.percentile(np.abs(positions), 100, 0)
    radii = np.concatenate([radii, [1.0]])

    cam2world = poses_avg(poses3)
    up = poses3[:, :3, 1].mean(0)
    out = []
    for _ in range(n_poses):
        t = radii * np.concatenate([2 * rng.random(3) - 1.0, [1.0]])
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        rp = np.eye(4)
        rp[:3] = viewmatrix(z_axis, up, position)
        rp = np.linalg.inv(transform) @ rp
        rp[:3, 1:3] *= -1
        rp[:3, 3] /= scale
        out.append(np.linalg.inv(rp))
    return np.stack(out, axis=0)


def generate_spiral_path(
    Rs, Ts, bounds, n_frames: int = 180, n_rots: int = 2, zrate: float = 0.5
) -> np.ndarray:
    """Forward-facing spiral render path (reference pose_utils.py:51-79
    applied to camera-convention poses). Returns [N, 4, 4] W2C."""
    poses = np.stack([_c2w_from_camera(R, T) for R, T in zip(Rs, Ts)], 0)
    bounds = np.asarray(bounds, np.float64)
    scale = 1.0 / (bounds.min() * 0.75)
    poses[:, :3, 3] *= scale
    bounds = bounds * scale
    poses3, transform = recenter_poses(poses[:, :3, :4])

    close_depth, inf_depth = bounds.min() * 0.9, bounds.max() * 5.0
    dt = 0.75
    focal = 1.0 / ((1 - dt) / close_depth + dt / inf_depth)
    positions = poses3[:, :3, 3]
    radii = np.percentile(np.abs(positions), 90, 0)
    radii = np.concatenate([radii, [1.0]])

    cam2world = poses_avg(poses3)
    up = poses3[:, :3, 1].mean(0)
    out = []
    for theta in np.linspace(0.0, 2.0 * np.pi * n_rots, n_frames, endpoint=False):
        t = radii * [np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0]
        position = cam2world @ t
        lookat = cam2world @ [0, 0, -focal, 1.0]
        z_axis = position - lookat
        rp = np.eye(4)
        rp[:3] = viewmatrix(z_axis, up, position)
        rp = np.linalg.inv(transform) @ rp
        rp[:3, 1:3] *= -1
        rp[:3, 3] /= scale
        out.append(np.linalg.inv(rp))
    return np.stack(out, axis=0)
