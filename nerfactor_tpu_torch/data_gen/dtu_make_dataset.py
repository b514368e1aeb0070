"""Converts a DTU scene's cameras.npz + image/ into the framework's
per-view layout (same spherified layout as the real-capture path;
counterpart of data_gen_tpu/dtu_make_dataset.py, on the port's camera
decomposition, image IO and resize; runs on the host).

CLI parity with data_gen/dtu_mvs/make_dataset.py:
  python -m nerfactor_tpu_torch.data_gen.dtu_make_dataset \
      --scene_dir=/path/to/dtu_scan --outroot=/out [--h=256] [--n_vali=2]

``main`` returns the views written and the seconds taken.
"""

import argparse
import os
import shutil
from os.path import join, basename, exists
from time import perf_counter

import numpy as np

from nerfactor_tpu_torch.data_gen import camera as camlib
from nerfactor_tpu_torch.data_gen.nerf_real_make_dataset import (
    convert, load_views)
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="data_gen/dtu")

# DTU (OpenCV) camera axes -> OpenGL/NeRF axes
_CV2GL = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0],
                   [0, 0, 0, 1]], np.float64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--scene_dir', required=True)
    p.add_argument('--h', type=int, default=256)
    p.add_argument('--n_vali', type=int, default=2)
    p.add_argument('--outroot', required=True)
    p.add_argument('--debug', action='store_true')
    p.add_argument('--overwrite', action='store_true')
    return p.parse_args(argv)


def dtu_pose(world_mat, scale_mat):
    """One DTU camera -> (c2w 4x4 OpenGL convention, focal length).

    Reference math: data_gen/dtu_mvs/make_dataset.py:52-76 -- decompose
    the projection, invert to camera-to-world, normalize translation by
    the scene scale matrix, and flip CV -> GL axes on both sides.
    """
    P = world_mat[:3]
    K, R, c = camlib.decompose_projection(P)
    f = (K[0, 0] + K[1, 1]) / 2
    pose = np.eye(4)
    pose[:3, :3] = R.T  # c2w rotation
    pose[:3, 3] = c
    norm_trans = scale_mat[:3, 3]
    norm_scale = np.diagonal(scale_mat[:3, :3])
    pose[:3, 3] = (pose[:3, 3] - norm_trans) / norm_scale
    pose = _CV2GL @ pose @ _CV2GL
    return pose, f


def main(argv=None):
    args = parse_args(argv)
    t0 = perf_counter()
    if args.overwrite and exists(args.outroot):
        shutil.rmtree(args.outroot)
    os.makedirs(args.outroot, exist_ok=True)
    cams = np.load(join(args.scene_dir, 'cameras.npz'))
    img_paths = [p for p in ioutil.sortglob(join(args.scene_dir, 'image'))
                 if p.endswith('.png')]
    if args.debug:
        img_paths = img_paths[:4]
    imgs, factor = load_views(img_paths, args.h)
    poses = []
    for img_path in img_paths:
        i = int(basename(img_path)[:-len('.png')])
        pose, f = dtu_pose(cams['world_mat_%d' % i],
                           cams['scale_mat_%d' % i])
        hwf = np.array([imgs.shape[1], imgs.shape[2], f / factor])
        poses.append(np.hstack((pose[:3, :], hwf.reshape(3, 1))))
    poses = np.stack(poses, axis=0).astype(np.float32)
    return convert(poses, imgs, img_paths, args.n_vali, args.outroot, t0)


if __name__ == '__main__':
    main()
