"""Camera-pose math for real (COLMAP/LLFF) captures on NumPy: recentering
onto the average pose, spherification, and the test spiral (the port's
own copy of data_gen_tpu/poses.py, with its dtypes: the math runs in
float64 wherever NumPy promotes to it).

Behavioral contract: data_gen/util.py:22-124 in the reference (itself the
standard LLFF/NeRF pose pipeline). Poses are Nx3x5, the last column
holding (H, W, focal).
"""

import numpy as np


def _unit(x):
    return x / np.linalg.norm(x)


def view_matrix(z, up, pos):
    """Look-at camera-to-world basis: columns (right, up', forward, pos)."""
    vec2 = _unit(z)
    vec0 = _unit(np.cross(up, vec2))
    vec1 = _unit(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def average_pose(poses):
    """(N,3,5) -> (3,5) average camera (center + mean viewing dir)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = _unit(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([view_matrix(vec2, up, center), hwf], axis=1)


def recenter_poses(poses):
    """Rigidly moves all cameras so their average pose is the identity."""
    poses = poses.copy()
    bottom = np.array([0, 0, 0, 1.0]).reshape(1, 4)
    c2w_avg = np.concatenate([average_pose(poses)[:3, :4], bottom], axis=0)
    homog = np.concatenate(
        [poses[:, :3, :4],
         np.tile(bottom[None], (poses.shape[0], 1, 1))], axis=1)
    recentered = np.linalg.inv(c2w_avg) @ homog
    poses[:, :3, :4] = recentered[:, :3, :4]
    return poses


def _closest_point_to_rays(rays_o, rays_d):
    """Least-squares point minimizing distance to all camera axes."""
    a = np.eye(3) - rays_d * np.transpose(rays_d, (0, 2, 1))
    b = -a @ rays_o
    return np.squeeze(-np.linalg.inv(
        (np.transpose(a, (0, 2, 1)) @ a).mean(0)) @ b.mean(0))


def spherify_poses(poses, n_test_views=120):
    """Re-orients captures onto a unit sphere around the scene and builds
    a circular test trajectory (reference data_gen/util.py:22-81).

    Returns:
      poses_reset: (N, 3, 5) input cameras in the spherified frame.
      test_poses: (n_test_views, 3, 5) circular render path.
    """
    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    center = _closest_point_to_rays(rays_o, rays_d)
    up = (poses[:, :3, 3] - center).mean(0)

    vec0 = _unit(up)
    vec1 = _unit(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = _unit(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], axis=1)

    def to44(p):
        bottom = np.tile(np.eye(4)[-1:].reshape(1, 1, 4),
                         (p.shape[0], 1, 1))
        return np.concatenate([p, bottom], axis=1)

    poses_reset = np.linalg.inv(to44(c2w[None])) @ to44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(poses_reset[:, :3, 3] ** 2, axis=-1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    rad *= sc
    centroid = poses_reset[:, :3, 3].mean(0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)

    test_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, n_test_views):
        cam_origin = np.array(
            [radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = _unit(cam_origin)
        vec0 = _unit(np.cross(vec2, up))
        vec1 = _unit(np.cross(vec2, vec0))
        test_poses.append(np.stack([vec0, vec1, vec2, cam_origin], axis=1))
    test_poses = np.stack(test_poses, axis=0)
    hwf = np.broadcast_to(poses[0, :3, -1:],
                          (test_poses.shape[0], 3, 1))
    test_poses = np.concatenate([test_poses, hwf], axis=-1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:],
                         (poses_reset.shape[0], 3, 1))], axis=-1)
    return poses_reset, test_poses
