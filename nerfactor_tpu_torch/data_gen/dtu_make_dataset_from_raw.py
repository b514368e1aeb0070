"""Converts RAW DTU captures (pos_???.txt projection matrices +
rectified images) into the framework's per-view layout, mirroring
the LLFF-style recenter/spherify pipeline.

Reference behavior: data_gen/dtu_mvs/make_dataset_from_raw.py:1-97 --
per scene: glob `pos_???.txt` 3x4 projection matrices from --cam_dir
and the most-diffusely-lit images (`*_3_*.png`) from
--img_root/<scene>, resize to --h, decompose each P into K/R/t
(cv2.decomposeProjectionMatrix there; our own RQ-based
camera.decompose_projection here), convert the world-to-camera CV
extrinsics to OpenGL camera-to-world, pack LLFF Nx3x5 hwf poses, and
feed the shared gen_data writer (recenter -> spherify -> per-view
rgba.png + metadata.json + transforms_*.json). Counterpart of
data_gen_tpu/dtu_make_dataset_from_raw.py, on the port's camera
decomposition, image IO and resize; runs on the host.

CLI parity:
  python -m nerfactor_tpu_torch.data_gen.dtu_make_dataset_from_raw \
      --cam_dir=/dtu/Calibration/cal18 --img_root=/dtu/Rectified \
      --outroot=/out --scenes=scan105,scan106 [--h=256] [--n_vali=2]

``main`` returns each converted scene's views and seconds.
"""

import argparse
import os
from os.path import join, basename
from time import perf_counter

import numpy as np

from nerfactor_tpu_torch.data_gen import camera as camlib
from nerfactor_tpu_torch.data_gen.nerf_real_make_dataset import (
    convert, load_views)
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="data_gen/dtu_raw")

# OpenCV camera axes (x right, y down, z forward) -> OpenGL/NeRF
# (x right, y up, z backward); reference uses xm.camera.CVCAM_TO_GLCAM
CVCAM_TO_GLCAM = np.array(
    [[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 0], [0, 0, 0, 1]],
    np.float64)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--cam_dir', required=True,
                   help="directory of pos_???.txt projection matrices")
    p.add_argument('--img_root', required=True,
                   help="root holding <scene>/ image dirs")
    p.add_argument('--scenes', required=True,
                   help="comma-separated scene names under img_root")
    p.add_argument('--h', type=int, default=256)
    p.add_argument('--n_vali', type=int, default=2)
    p.add_argument('--outroot', required=True)
    p.add_argument('--debug', action='store_true')
    p.add_argument('--overwrite', action='store_true')
    return p.parse_args(argv)


def pose_from_projection(P, factor, imh, imw):
    """One 3x4 DTU projection matrix -> LLFF 3x5 (c2w | hwf) pose.

    Matches make_dataset_from_raw.py:69-85: K from the projection
    decomposition, w2c = inv(K) P (CV), CV->GL axis flip, invert to
    c2w, single focal = mean(fx, fy) scaled by the resize factor.
    """
    P = np.asarray(P, np.float64)
    K, _, _ = camlib.decompose_projection(P)
    rt = np.linalg.inv(K) @ P  # w2c, CV convention
    rt = CVCAM_TO_GLCAM[:3, :3] @ rt  # w2c, GL convention
    f = (K[0, 0] + K[1, 1]) / 2
    f *= 1.0 / factor
    rt = np.vstack([rt, [0, 0, 0, 1]])
    c2w = np.linalg.inv(rt)
    hwf = np.array([imh, imw, f], np.float64).reshape(3, 1)
    return np.hstack((c2w[:3, :], hwf))


def load_raw_scene(cam_dir, img_dir, out_h, debug=False):
    """-> (poses Nx3x5, imgs NxHxWx4, img_paths)."""
    cam_paths = [p for p in ioutil.sortglob(cam_dir)
                 if basename(p).startswith('pos_')
                 and p.endswith('.txt')]
    img_paths = [p for p in ioutil.sortglob(img_dir)
                 if '_3_' in basename(p) and p.lower().endswith('.png')]
    # In case only the first cameras were used to capture images
    cam_paths = cam_paths[:len(img_paths)]
    if debug:
        cam_paths, img_paths = cam_paths[:4], img_paths[:4]
    if len(cam_paths) != len(img_paths):
        raise ValueError(
            "Mismatch between numbers of images (%d) and poses (%d)"
            % (len(img_paths), len(cam_paths)))
    # NOTE: an all-one alpha is added (reference :62-64)
    imgs, factor = load_views(img_paths, out_h)
    poses = [pose_from_projection(np.loadtxt(p), factor, imgs.shape[1],
                                  imgs.shape[2]) for p in cam_paths]
    poses = np.stack(poses, axis=0).astype(np.float32)
    return poses, imgs, img_paths


def main(argv=None):
    args = parse_args(argv)
    os.makedirs(args.outroot, exist_ok=True)
    records = {}
    for scene in args.scenes.split(','):
        outdir = join(args.outroot, scene)
        if os.path.exists(outdir) and not args.overwrite:
            logger.info("Skipping existing %s", outdir)
            continue
        t0 = perf_counter()
        poses, imgs, img_paths = load_raw_scene(
            args.cam_dir, join(args.img_root, scene), args.h,
            debug=args.debug)
        records[scene] = convert(poses, imgs, img_paths, args.n_vali,
                                 outdir, t0)
    return records


if __name__ == '__main__':
    main()
