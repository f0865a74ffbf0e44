"""Spiral camera path for novel-view videos; counterpart of ``nerf_tpu/render/spiral.py``.

A numpy copy: n_rots turns round the mean camera centre at the mean radius,
with a sinusoidal vertical motion, each camera looking at the centre in the
NeRF/OpenGL convention (it views along -Z). The JAX package's look-at fix
is kept: its reference pointed +Z at the centre, so its cameras faced away
from the scene.
"""
from __future__ import annotations

import numpy as np


def generate_spiral_poses(
    poses: np.ndarray, n_frames: int = 120, n_rots: int = 2, zrate: float = 0.5
) -> np.ndarray:
    """poses: [N, 4, 4] dataset camera poses -> [n_frames, 4, 4]."""
    poses = np.asarray(poses)
    positions = poses[:, :3, 3]
    center = positions.mean(axis=0)

    forward = poses[:, :3, 2].mean(axis=0)
    forward = forward / np.linalg.norm(forward)
    up = poses[:, :3, 1].mean(axis=0)
    up = up / np.linalg.norm(up)
    right = np.cross(forward, up)
    right = right / np.linalg.norm(right)
    up = np.cross(right, forward)

    radius = np.linalg.norm(positions - center, axis=1).mean()

    render_poses = []
    for i in range(n_frames):
        theta = 2 * np.pi * n_rots * i / n_frames
        phi = zrate * np.sin(2 * np.pi * i / n_frames)
        cam_pos = center + radius * (np.cos(theta) * right + np.sin(theta) * forward) + phi * up
        # the camera views along -Z, so the pose's Z column points away
        # from the target
        cam_z = cam_pos - center
        cam_z = cam_z / np.linalg.norm(cam_z)
        cam_right = np.cross(up, cam_z)
        cam_right = cam_right / np.linalg.norm(cam_right)
        cam_up = np.cross(cam_z, cam_right)
        pose = np.eye(4)
        pose[:3, 0] = cam_right
        pose[:3, 1] = cam_up
        pose[:3, 2] = cam_z
        pose[:3, 3] = cam_pos
        render_poses.append(pose)
    return np.stack(render_poses).astype(np.float32)
