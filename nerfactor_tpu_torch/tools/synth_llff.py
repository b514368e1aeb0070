"""A synthetic LLFF (COLMAP) capture on NumPy: the input layout that
data_gen/nerf_real_make_dataset.py reads, of the analytic sphere of
tools/synth_scene.py.

  python -m nerfactor_tpu_torch.tools.synth_llff --root=DIR \\
      [--n_views=20] [--imh=756] [--imw=1008] [--ext=jpg] [--seed=0]

Writes under --root, as LLFF's ``imgs2poses.py`` and a downsampled image
folder lay them out:
  * ``images/img_%03d.<ext>``: the sphere, shaded as in synth_scene.py,
    in front of a smooth sky gradient with a little seeded noise, seen
    from ``--n_views`` cameras on a forward-facing arc (azimuth -40 to
    +40 degrees, elevation 20 to 30, 4 units out); JPEG (quality 95,
    through PIL) or PNG;
  * ``poses_bounds.npy``: one row a view, the 3 x 5 pose (LLFF's camera
    axes: down, right, backward; then height, width, focal length)
    flattened, then the near and far bounds.

At the defaults the images are LLFF's ``images_4`` size (1008 x 756).
"""

import argparse
import os
from os.path import join

import numpy as np

from nerfactor_tpu_torch.tools import synth_scene
from nerfactor_tpu_torch.utils import io as ioutil


def arc_cameras(n_views, dist=synth_scene.CAM_DIST):
    """NeRF-convention camera-to-world matrices (x right, y up, z back)
    on a forward-facing arc towards the origin."""
    cams = []
    for i in range(n_views):
        frac = i / max(n_views - 1, 1)
        az = np.deg2rad(-40.0 + 80.0 * frac)
        el = np.deg2rad(20.0 + 10.0 * np.sin(np.pi * frac))
        loc = dist * np.array([np.cos(el) * np.cos(az),
                               np.cos(el) * np.sin(az), np.sin(el)])
        cams.append(synth_scene.look_at_c2w(loc))
    return cams


def render(c2w, imh, imw, rng):
    """(imh, imw, 3) float image in [0, 1]: the shaded sphere over a sky
    gradient."""
    rayo, rayd = synth_scene.gen_rays(c2w, imh, imw)
    hit, t, d = synth_scene.ray_sphere(rayo, rayd)
    xyz = rayo + d * t[..., None]
    sky = np.stack([0.45 + 0.25 * d[..., 2], 0.55 + 0.2 * d[..., 0],
                    0.7 + 0.2 * d[..., 1]], axis=-1)
    rgb = np.where(hit[..., None],
                   synth_scene.shade(xyz, xyz / synth_scene.SPHERE_R), sky)
    rgb = rgb + 0.02 * rng.randn(imh, imw, 3)
    return np.clip(rgb, 0.0, 1.0).astype(np.float32)


def write_image(rgb, path):
    if path.endswith('.png'):
        ioutil.write_img(rgb, path)
        return
    from PIL import Image
    Image.fromarray((rgb * 255).astype(np.uint8)).save(path, quality=95)


def make_capture(root, n_views=20, imh=756, imw=1008, ext='jpg', seed=0):
    """Writes the capture (see the module docstring); ``ext`` is one
    extension or one a view. Returns {'scene_dir', 'images', 'focal'}."""
    img_dir = join(root, 'images')
    os.makedirs(img_dir, exist_ok=True)
    exts = [ext] * n_views if isinstance(ext, str) else list(ext)
    focal = 0.5 * imw / np.tan(0.5 * synth_scene.ANGLE_X)
    rng = np.random.RandomState(seed)
    rows, paths = [], []
    for i, c2w in enumerate(arc_cameras(n_views)):
        path = join(img_dir, 'img_%03d.%s' % (i, exts[i]))
        write_image(render(c2w, imh, imw, rng), path)
        paths.append(path)
        nerf = c2w[:3, :4]  # columns: right, up, backward
        llff = np.concatenate([-nerf[:, 1:2], nerf[:, 0:1], nerf[:, 2:]],
                              axis=1)
        pose = np.concatenate(
            [llff, np.array([imh, imw, focal]).reshape(3, 1)], axis=1)
        near_far = np.array([synth_scene.CAM_DIST - 1.5,
                             synth_scene.CAM_DIST + 1.5])
        rows.append(np.concatenate([pose.ravel(), near_far]))
    np.save(join(root, 'poses_bounds.npy'), np.stack(rows))
    return {'scene_dir': root, 'images': paths, 'focal': focal}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--root', required=True)
    p.add_argument('--n_views', type=int, default=20)
    p.add_argument('--imh', type=int, default=756)
    p.add_argument('--imw', type=int, default=1008)
    p.add_argument('--ext', default='jpg', choices=['jpg', 'png'])
    p.add_argument('--seed', type=int, default=0)
    args = p.parse_args(argv)
    return make_capture(args.root, n_views=args.n_views, imh=args.imh,
                        imw=args.imw, ext=args.ext, seed=args.seed)


if __name__ == '__main__':
    main()
