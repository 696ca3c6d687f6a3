"""Pseudo-view pose generation and render paths (host-side numpy).

Counterpart of ``sdpgs_tpu/data/pose_sampling.py`` (reference
utils/pose_utils.py):
- ``generate_random_poses_llff`` (:262-308): 10k poses sampled in the
  bounds-scaled, recentred camera volume, each looking at a
  disparity-weighted focus depth;
- ``generate_random_poses_interp`` (:386-444, DTU): a random pair of train
  views, slerp of the rotations and lerp of the translations with values in
  [0, 0.5) and [0, 0.1);
- ``generate_random_poses_360`` (:446-503): an ellipse around the
  PCA-aligned capture at random angles;
- the spiral and ellipse render paths (:51-155, :194-257).

The generators return [N, 4, 4] world-to-camera matrices; a pseudo camera
takes ``R = pose[:3, :3].T``, ``T = pose[:3, 3]`` (reference
scene/__init__.py:174-178). The same ``rng`` gives the JAX package's poses.
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


def focus_point_fn(poses):
    """Nearest point to all focal axes (reference pose_utils.py:33-39);
    pinv for robustness when all axes are parallel."""
    directions, origins = poses[:, :3, 2:3], poses[:, :3, 3:4]
    m = np.eye(3) - directions * np.transpose(directions, [0, 2, 1])
    mt_m = np.transpose(m, [0, 2, 1]) @ m
    return np.linalg.pinv(mt_m.mean(0)) @ (mt_m @ origins).mean(0)[:, 0]


def recenter_poses(poses):
    cam2world = poses_avg(poses)
    transform = np.linalg.inv(pad_poses(cam2world[None]))[0]
    poses = transform @ pad_poses(poses)
    return unpad_poses(poses), transform


def transform_poses_pca(poses):
    """PCA-align + rescale (reference pose_utils.py:157-192)."""
    t = poses[:, :3, 3]
    t_mean = t.mean(axis=0)
    t = t - t_mean
    eigval, eigvec = np.linalg.eigh(t.T @ t)
    inds = np.argsort(eigval)[::-1]
    eigvec = eigvec[:, inds]
    rot = eigvec.T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1, 1, -1])) @ rot
    transform = np.concatenate([rot, rot @ -t_mean[:, None]], -1)
    poses_recentered = unpad_poses(transform @ pad_poses(poses))
    if poses_recentered.mean(axis=0)[2, 1] < 0:
        poses_recentered = np.diag(np.array([1, -1, -1])) @ poses_recentered
        transform = np.diag(np.array([1, -1, -1, 1])) @ np.concatenate(
            [transform, np.array([[0, 0, 0, 1.0]])], axis=0
        )
    else:
        transform = np.concatenate([transform, np.array([[0, 0, 0, 1.0]])], axis=0)
    scale_factor = 1.0 / np.max(np.abs(poses_recentered[:, :3, 3]))
    poses_recentered[:, :3, 3] *= scale_factor
    transform = np.diag(np.array([scale_factor] * 3 + [1.0])) @ transform
    return poses_recentered, transform


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


def _rodrigues_to_mat(rvec: np.ndarray) -> np.ndarray:
    theta = np.linalg.norm(rvec)
    if theta < 1e-12:
        return np.eye(3)
    k = rvec / theta
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(theta) * K + (1 - np.cos(theta)) * (K @ K)


def _mat_to_rodrigues(R: np.ndarray) -> np.ndarray:
    cos_t = np.clip((np.trace(R) - 1) / 2, -1, 1)
    theta = np.arccos(cos_t)
    if theta < 1e-12:
        return np.zeros(3)
    v = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return theta / (2 * np.sin(theta)) * v


def _slerp_vec(val, low, high):
    """Spherical interp of axis-angle vectors (reference pose_utils.py:325-335,
    which applies 'slerp' to Rodrigues vectors)."""
    if val <= 0:
        return low
    if val >= 1:
        return high
    nl, nh = np.linalg.norm(low), np.linalg.norm(high)
    if nl < 1e-12 or nh < 1e-12 or np.allclose(low, high):
        return low
    omega = np.arccos(np.clip(np.dot(low / nl, high / nh), -1, 1))
    so = np.sin(omega)
    if abs(so) < 1e-12:
        return low
    return np.sin((1.0 - val) * omega) / so * low + np.sin(val * omega) / so * high


def generate_random_poses_interp(
    Rs: Sequence[np.ndarray],
    Ts: Sequence[np.ndarray],
    n_poses: int = 10000,
    slerp_range: float = 0.5,
    lerp_range: float = 0.1,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Random-pair slerp/lerp pose synthesis (reference
    generate_random_poses_llff_ours / _blender, pose_utils.py:359-444).
    Returns [N, 4, 4] W2C."""
    rng = rng or np.random.default_rng(0)
    n_views = len(Rs)
    out = []
    for _ in range(n_poses):
        i, j = rng.choice(n_views, size=2, replace=False)
        sv = rng.random() * slerp_range
        lv = rng.random() * lerp_range
        r1 = _mat_to_rodrigues(Rs[i])
        r2 = _mat_to_rodrigues(Rs[j])
        R = _rodrigues_to_mat(_slerp_vec(sv, r1, r2))
        T = Ts[i] + (Ts[j] - Ts[i]) * lv
        pose = np.eye(4)
        pose[:3, :3] = R.T
        pose[:3, 3] = T
        out.append(pose)
    return np.stack(out, axis=0)


def generate_random_poses_360(
    Rs: Sequence[np.ndarray],
    Ts: Sequence[np.ndarray],
    n_poses: int = 10000,
    z_variation: float = 0.1,
    z_phase: float = 0.0,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """reference pose_utils.py:446-503. Returns [N, 4, 4] W2C."""
    rng = rng or np.random.default_rng(0)
    poses = np.stack([_c2w_from_camera(R, T) for R, T in zip(Rs, Ts)], 0)
    poses3, transform = transform_poses_pca(poses)

    center = focus_point_fn(poses3)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses3[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses3[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses3[:, :3, 3], 90, axis=0)

    theta = rng.random(n_poses + 1) * 2.0 * np.pi
    positions = np.stack(
        [
            low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
            low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
            z_variation
            * (z_low[2] + (z_high - z_low)[2] * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
        ],
        -1,
    )[:-1]

    avg_up = poses3[:, :3, 1].mean(0)
    avg_up = avg_up / np.linalg.norm(avg_up)
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

    out = []
    for p in positions:
        rp = np.eye(4)
        rp[:3] = viewmatrix(p - center, up, p)
        rp = np.linalg.inv(transform) @ rp
        rp[:3, 1:3] *= -1
        # inv(transform) carries the PCA scale into the 3x3 (the reference
        # keeps it, pose_utils.py:500-502 — projection is scale-invariant,
        # but normalized rotations make well-formed cameras).
        s = np.cbrt(abs(np.linalg.det(rp[:3, :3])))
        rp[:3, :3] /= s
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


def generate_ellipse_path(
    Rs: Sequence[np.ndarray],
    Ts: Sequence[np.ndarray],
    n_frames: int = 600,
    const_speed: bool = True,
    z_variation: float = 0.0,
    z_phase: float = 0.0,
) -> np.ndarray:
    """360 ellipse render path (reference pose_utils.py:194-257): PCA-align
    the capture, walk an ellipse around the focus point, optionally
    resampled to constant speed via the step-function inverter. Returns
    [N, 4, 4] W2C."""
    from sdpgs_torch.data.stepfun import sample_np

    poses = np.stack([_c2w_from_camera(R, T) for R, T in zip(Rs, Ts)], 0)
    poses3, transform = transform_poses_pca(poses)

    center = focus_point_fn(poses3)
    offset = np.array([center[0], center[1], 0])
    sc = np.percentile(np.abs(poses3[:, :3, 3] - offset), 90, axis=0)
    low = -sc + offset
    high = sc + offset
    z_low = np.percentile(poses3[:, :3, 3], 10, axis=0)
    z_high = np.percentile(poses3[:, :3, 3], 90, axis=0)

    def get_positions(theta):
        return np.stack(
            [
                low[0] + (high - low)[0] * (np.cos(theta) * 0.5 + 0.5),
                low[1] + (high - low)[1] * (np.sin(theta) * 0.5 + 0.5),
                z_variation
                * (z_low[2] + (z_high - z_low)[2]
                   * (np.cos(theta + 2 * np.pi * z_phase) * 0.5 + 0.5)),
            ],
            -1,
        )

    theta = np.linspace(0, 2.0 * np.pi, n_frames + 1, endpoint=True)
    positions = get_positions(theta)
    if const_speed:
        lengths = np.linalg.norm(positions[1:] - positions[:-1], axis=-1)
        theta = sample_np(None, theta, np.log(np.maximum(lengths, 1e-12)),
                          n_frames + 1)
        positions = get_positions(theta)
    positions = positions[:-1]

    avg_up = poses3[:, :3, 1].mean(0)
    avg_up = avg_up / np.linalg.norm(avg_up)
    ind_up = np.argmax(np.abs(avg_up))
    up = np.eye(3)[ind_up] * np.sign(avg_up[ind_up])

    out = []
    for pos in positions:
        rp = np.eye(4)
        rp[:3] = viewmatrix(pos - center, up, pos)
        rp = np.linalg.inv(transform) @ rp
        rp[:3, 1:3] *= -1
        s = np.cbrt(abs(np.linalg.det(rp[:3, :3])))
        rp[:3, :3] /= s
        out.append(np.linalg.inv(rp))
    return np.stack(out, axis=0)


def render_spiral_path(
    poses3: np.ndarray, bounds: np.ndarray, n_frames: int = 180,
    n_rots: int = 2, zrate: float = 0.5,
) -> np.ndarray:
    """Forward-facing spiral over *recentered* [N, 3, 4] LLFF poses
    (reference render_generate_spiral_path, pose_utils.py:51-79): unlike
    ``generate_spiral_path`` there is no bounds rescale and the output stays
    in the recentered c2w frame (``backcenter_poses`` maps it back)."""
    bounds = np.asarray(bounds, np.float64)
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
        out.append(viewmatrix(z_axis, up, position))
    return np.stack(out, axis=0)


def backcenter_poses(poses: np.ndarray, pose_ref: np.ndarray) -> np.ndarray:
    """Undo ``recenter_poses`` using the reference capture's average pose
    (reference pose_utils.py:80-84)."""
    cam2world = poses_avg(pose_ref)
    return unpad_poses(pad_poses(cam2world) @ pad_poses(poses))


def convert_poses(poses: np.ndarray):
    """[3, 5, N] LLFF-format render poses -> (Rs, tvecs, H, W, focal)
    world-to-camera decomposition (reference pose_utils.py:85-101)."""
    poses = np.concatenate(
        [poses[:, 1:2], poses[:, 0:1], -poses[:, 2:3], poses[:, 3:4], poses[:, 4:5]],
        axis=1,
    ).transpose(2, 0, 1)
    bottom = np.tile(np.array([0, 0, 0, 1.0]).reshape(1, 1, 4), (poses.shape[0], 1, 1))
    H, W, focal = poses[0, :, -1]
    w2c = np.linalg.inv(np.concatenate([poses[..., :4], bottom], axis=1))
    return w2c[:, :3, :3], w2c[:, :3, -1], H, W, focal
