"""Converts a COLMAP/LLFF real capture (poses_bounds.npy + images/) into
the framework's per-view layout: '<mode>_???/rgba.png' + metadata.json,
plus a 120-view spherified test spiral with nearest-input 'nn.png' per
test view, plus transforms_{train,val,test}.json for NeRF-codebase
interop (counterpart of data_gen_tpu/nerf_real_make_dataset.py, on the
port's image IO and resize; runs on the host).

CLI parity with data_gen/nerf_real/make_dataset.py:
  python -m nerfactor_tpu_torch.data_gen.nerf_real_make_dataset \
      --scene_dir=/path/to/colmap_scene --outroot=/out \
      [--h=512] [--n_vali=2] [--bound_factor=0.75] [--debug]

Images may be JPEG (read through PIL) or PNG. ``main`` returns the
views written and the seconds taken.
"""

import argparse
import json
import os
from os.path import join

from time import perf_counter

import numpy as np

from nerfactor_tpu_torch.data_gen import poses as poselib
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="data_gen/nerf_real")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--scene_dir', required=True)
    p.add_argument('--h', type=int, default=512)
    p.add_argument('--n_vali', type=int, default=2)
    p.add_argument('--bound_factor', type=float, default=0.75)
    p.add_argument('--outroot', required=True)
    p.add_argument('--debug', action='store_true')
    return p.parse_args(argv)


def load_views(img_paths, out_h):
    """The images at height ``out_h``, an all-one alpha added where they
    have none, stacked: (N, out_h, W, 4) and the common downscale
    factor (input height / ``out_h``)."""
    if not img_paths:
        raise FileNotFoundError("No image globbed")
    imgs, factor = [], None
    for path in img_paths:
        img = ioutil.load_img(path)
        if factor is None:
            factor = float(img.shape[0]) / out_h
        elif float(img.shape[0]) / out_h != factor:
            raise ValueError("Images are of varying sizes: %s" % path)
        img = imgops.resize(img, new_h=out_h)
        if img.shape[2] == 3:
            img = np.dstack((img, np.ones_like(img[:, :, :1])))
        imgs.append(img)
    return np.stack(imgs, axis=0), factor


def load_colmap_scene(scene_dir, out_h, bound_factor, debug=False):
    """poses_bounds.npy + images/ -> (poses Nx3x5, imgs NxHxWx4,
    img_paths)."""
    poses_arr = ioutil.load_np(join(scene_dir, 'poses_bounds.npy'))
    poses = poses_arr[:, :-2].reshape(-1, 3, 5)
    bds = poses_arr[:, -2:]
    img_paths = [p for p in ioutil.sortglob(join(scene_dir, 'images'))
                 if p.lower().endswith(('.jpg', '.jpeg', '.png'))]
    if debug:
        img_paths, poses, bds = img_paths[:4], poses[:4], bds[:4]
    imgs, factor = load_views(img_paths, out_h)
    if poses.shape[0] != imgs.shape[0]:
        raise ValueError(
            "Mismatch between numbers of images (%d) and poses (%d)"
            % (imgs.shape[0], poses.shape[0]))
    # Update (H, W, focal) for the downsampling
    poses[:, :2, 4] = np.array(imgs.shape[1:3]).reshape(1, 2)
    poses[:, 2, 4] = poses[:, 2, 4] / factor
    # LLFF's (down, right, backward) -> NeRF's (right, up, backward)
    poses = np.concatenate(
        [poses[:, :, 1:2], -poses[:, :, 0:1], poses[:, :, 2:]], axis=2)
    poses = poses.astype(np.float32)
    bds = bds.astype(np.float32)
    # Rescale so the near bound sits at bound_factor
    scale = 1.0 / (bds.min() * bound_factor)
    poses[:, :3, 3] *= scale
    return poses, imgs, img_paths


def _frame_meta(c2w, cam_angle_x, imh, imw, original_path=''):
    return {
        'cam_angle_x': float(cam_angle_x),
        'cam_transform_mat': ','.join(str(x) for x in c2w.ravel()),
        'envmap': '', 'envmap_inten': 0, 'imh': int(imh), 'imw': int(imw),
        'scene': '', 'spp': 0, 'original_path': original_path}


def _c2w44(pose):
    return np.vstack((pose[:3, :4], np.array([[0, 0, 0, 1.0]])))


def write_views(poses, test_poses, imgs, img_paths, n_vali, outroot):
    """Writes the per-view folders + NeRF-interop transform JSONs
    (reference data_gen/util.py:214-318); returns the number of views
    written by mode."""
    os.makedirs(outroot, exist_ok=True)
    n_imgs = imgs.shape[0]
    ind_vali = np.arange(n_imgs)[:-1:max(1, n_imgs // n_vali)]
    ind_train = np.array(
        [x for x in np.arange(n_imgs) if x not in ind_vali])
    fl = poses[0, -1, -1]
    cam_angle_x = np.arctan2(imgs.shape[2] / 2, fl) * 2
    imh, imw = imgs.shape[1:3]

    interop = {m: {'camera_angle_x': float(cam_angle_x), 'frames': []}
               for m in ('train', 'val', 'test')}
    for mode, inds in (('train', ind_train), ('val', ind_vali)):
        for vi, i in enumerate(inds):
            vdir = join(outroot, '%s_%03d' % (mode, vi))
            ioutil.write_img(imgs[i], join(vdir, 'rgba.png'))
            c2w = _c2w44(poses[i])
            interop[mode]['frames'].append({
                'file_path': './%s_%03d/rgba' % (mode, vi), 'rotation': 0,
                'transform_matrix': c2w.tolist()})
            ioutil.write_json(
                _frame_meta(c2w, cam_angle_x, imh, imw, img_paths[i]),
                join(vdir, 'metadata.json'))
    for i in range(test_poses.shape[0]):
        vdir = join(outroot, 'test_%03d' % i)
        c2w = _c2w44(test_poses[i])
        interop['test']['frames'].append({
            'file_path': '', 'rotation': 0,
            'transform_matrix': c2w.tolist()})
        # Nearest input view, for reference in result videos
        dist = np.linalg.norm(
            test_poses[i, :, 3] - poses[:, :, 3], axis=1)
        nn_i = int(np.argmin(dist))
        ioutil.write_img(imgs[nn_i], join(vdir, 'nn.png'))
        ioutil.write_json(_frame_meta(c2w, cam_angle_x, imh, imw),
                          join(vdir, 'metadata.json'))
    for mode, name in (('train', 'transforms_train.json'),
                       ('val', 'transforms_val.json'),
                       ('test', 'transforms_test.json')):
        with open(join(outroot, name), 'w') as h:
            json.dump(interop[mode], h, indent=4)
    return {'train': len(ind_train), 'val': len(ind_vali),
            'test': test_poses.shape[0]}


def convert(poses, imgs, img_paths, n_vali, outroot, t0):
    """Recenters and spherifies ``poses``, writes the views; returns the
    record of a conversion that started at ``perf_counter()`` ``t0``."""
    poses = poselib.recenter_poses(poses)
    poses, test_poses = poselib.spherify_poses(poses)
    views = write_views(poses, test_poses, imgs, img_paths, n_vali, outroot)
    logger.info("Done: %s", outroot)
    return {'outroot': outroot, 'views': views, 'inputs': imgs.shape[0],
            'imh': int(imgs.shape[1]), 'imw': int(imgs.shape[2]),
            'seconds': perf_counter() - t0}


def main(argv=None):
    args = parse_args(argv)
    t0 = perf_counter()
    poses, imgs, img_paths = load_colmap_scene(
        args.scene_dir, args.h, args.bound_factor, debug=args.debug)
    return convert(poses, imgs, img_paths, args.n_vali, args.outroot, t0)


if __name__ == '__main__':
    main()
