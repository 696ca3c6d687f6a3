"""Pseudo-view pose generation for LLFF scenes (host-side numpy).

Counterpart of ``sdpgs_tpu/data/pose_sampling.py:1-145`` (reference
utils/pose_utils.py:15-45,262-308): ``generate_random_poses_llff`` samples
poses in the bounds-scaled, recentred camera volume, each looking at a
disparity-weighted focus depth. It returns [N, 4, 4] world-to-camera
matrices; a pseudo camera takes ``R = pose[:3, :3].T``, ``T = pose[:3, 3]``
(reference scene/__init__.py:174-178). The generators of the other
dataset flavours come with the data slice.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def normalize(x):
    return x / np.linalg.norm(x)


def viewmatrix(lookdir, up, position):
    """Camera-to-world 3x4 from a look direction (pose_utils.py:15-21)."""
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
    """Camera (R = C2W rotation, T = W2C translation) -> OpenGL-style C2W
    with y and z flipped (pose_utils.py:266-271)."""
    w2c = np.eye(4)
    w2c[:3] = np.concatenate([R.T, T[:, None]], 1)
    c2w = np.linalg.inv(w2c)
    c2w[:, 1:3] *= -1
    return c2w


def generate_random_poses_llff(Rs: Sequence[np.ndarray], Ts: Sequence[np.ndarray],
                               bounds: np.ndarray, n_poses: int = 10000,
                               rng: Optional[np.random.Generator] = None) -> np.ndarray:
    """Reference pose_utils.py:262-308: [n_poses, 4, 4] world-to-camera
    matrices around the train cameras (R, T per camera; ``bounds`` [V, 2]
    near/far depths). The same ``rng`` gives the JAX package's poses."""
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
