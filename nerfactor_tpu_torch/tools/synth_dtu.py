"""A DTU-style synthetic scan on NumPy: the input layout that
data_gen/dtu_surf_from_mvs.py reads, around an icosphere mesh.

  python -m nerfactor_tpu_torch.tools.synth_dtu --root=DIR [--imh=64] \\
      [--imw=IMH] [--n_views=4] [--subdiv=2] [--seed=0] [--processed]

Writes under --root, as a DTU release lays them out:
  * ``stl/stl042_l3_surf_11_trim_8.ply``: an icosphere of radius 2
    (icosahedron and ``--subdiv`` midpoint subdivisions: 20 * 4^subdiv
    faces) centred off the origin at (10, -5, 3), as real DTU scenes are;
  * ``cams/pos_%03d.txt``: 3 x 4 projection matrices K [R | t] of
    ``--n_views`` cameras on a ring 8 units out, looking at the centre
    with DTU's up (-z), focal length 60 / 64 of the image height;
  * ``scan42/rect_%03d_3_r5000.png``: ``--imh`` x ``--imw`` images
    (square by default; DTU's are 1200 x 1600) of uniform noise drawn
    from ``numpy.random.RandomState(--seed)``.

With ``--processed``, also the processed layout that
data_gen/dtu_make_dataset.py reads, from the same cameras and images:
``processed/cameras.npz`` (``world_mat_%d``: the projection as a 4 x 4;
``scale_mat_%d``: the sphere's centre and a radius of twice its own, as
DTU's normalization) and ``processed/image/%06d.png``, numbered from 0.

At its defaults the files are those of the ``dtu_scene`` fixture of
tests/test_dtu_mvs.py.
"""

import argparse
import os
import shutil
from os.path import join

import numpy as np

from nerfactor_tpu_torch.data_gen import camera as camlib, meshio
from nerfactor_tpu_torch.utils import io as ioutil

CENTER = (10.0, -5.0, 3.0)
RADIUS = 2.0
CAM_DIST = 8.0


def icosphere(r=1.0, subdiv=1):
    """Triangulated sphere: an icosahedron and ``subdiv`` midpoint
    subdivisions, vertices pushed onto the sphere. Returns (vertices
    (V, 3) float32, faces (F, 3) int64)."""
    t = (1 + np.sqrt(5)) / 2
    verts = np.array([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], float)
    faces = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], int)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    for _ in range(subdiv):
        new_faces, mids, vlist = [], {}, list(verts)

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in mids:
                m = (vlist[i] + vlist[j]) / 2
                mids[key] = len(vlist)
                vlist.append(m / np.linalg.norm(m))
            return mids[key]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [b, bc, ab], [c, ca, bc],
                          [ab, bc, ca]]
        verts = np.stack(vlist)
        faces = np.array(new_faces, int)
    return (r * verts).astype(np.float32), faces.astype(np.int64)


def make_scan(root, imh=64, n_views=4, subdiv=2, seed=0, imw=None):
    """Writes the scan (see the module docstring); returns {'cam_dir',
    'img_dir', 'surf_dir', 'center'}."""
    imw = imh if imw is None else imw
    center = np.array(CENTER)
    verts, faces = icosphere(r=RADIUS, subdiv=subdiv)
    cam_dir, img_dir, surf_dir = (join(root, d)
                                  for d in ('cams', 'scan42', 'stl'))
    for d in (cam_dir, img_dir, surf_dir):
        os.makedirs(d, exist_ok=True)
    meshio.write_ply(join(surf_dir, 'stl042_l3_surf_11_trim_8.ply'),
                     verts + center, faces)
    f = 60.0 * imh / 64
    K = np.array([[f, 0, imw / 2], [0, f, imh / 2], [0, 0, 1]])
    rng = np.random.RandomState(seed)
    for i in range(n_views):
        az = 2 * np.pi * i / n_views
        loc = center + CAM_DIST * np.array(
            [np.cos(az), np.sin(az), -0.5])  # DTU up is -z
        cam = camlib.PerspCam.from_lookat(K, loc, center, up=(0, 0, -1),
                                          imh=imh, imw=imw)
        np.savetxt(join(cam_dir, 'pos_%03d.txt' % (i + 1)), K @ cam.ext_mat)
        ioutil.write_img(rng.rand(imh, imw, 3).astype(np.float32),
                         join(img_dir, 'rect_%03d_3_r5000.png' % (i + 1)))
    return {'cam_dir': cam_dir, 'img_dir': img_dir, 'surf_dir': surf_dir,
            'center': center}


def make_processed(scan, root):
    """Writes the processed layout of ``scan`` (make_scan's record) under
    ``root`` (see the module docstring); returns its directory."""
    img_dir = join(root, 'image')
    os.makedirs(img_dir, exist_ok=True)
    scale_mat = np.eye(4)
    scale_mat[:3, :3] *= 2 * RADIUS
    scale_mat[:3, 3] = scan['center']
    cams = {}
    cam_paths = ioutil.sortglob(scan['cam_dir'], 'pos_*.txt')
    img_paths = ioutil.sortglob(scan['img_dir'], '*_3_*.png')
    for i, (cam_path, img_path) in enumerate(zip(cam_paths, img_paths)):
        world_mat = np.eye(4)
        world_mat[:3] = np.loadtxt(cam_path)
        cams['world_mat_%d' % i] = world_mat
        cams['scale_mat_%d' % i] = scale_mat
        shutil.copy(img_path, join(img_dir, '%06d.png' % i))
    np.savez(join(root, 'cameras.npz'), **cams)
    return root


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('--root', required=True)
    p.add_argument('--imh', type=int, default=64)
    p.add_argument('--imw', type=int, default=None)
    p.add_argument('--n_views', type=int, default=4)
    p.add_argument('--subdiv', type=int, default=2)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--processed', action='store_true')
    args = p.parse_args(argv)
    scan = make_scan(args.root, imh=args.imh, n_views=args.n_views,
                     subdiv=args.subdiv, seed=args.seed, imw=args.imw)
    if args.processed:
        scan['processed'] = make_processed(scan, join(args.root,
                                                      'processed'))
    return scan


if __name__ == '__main__':
    main()
