"""DTU MVS ingestion (counterpart of data_gen_tpu/dtu_surf_from_mvs.py;
reference data_gen/dtu_mvs/surf_from_mvs.py): per-view geometry buffers
(alpha, xyz, normal, lvis) by casting rays at the trimmed MVS surface
mesh, and the scene-shifted light sphere (lights.npz) that the MVS shape
and joint stages read.

  python -m nerfactor_tpu_torch.data_gen.dtu_surf_from_mvs \\
      --cam_dir=... --surf_dir=... --img_dir=... --outdir=... \\
      [--mesh_path=...] [--h=256] [--light_h=16] [--n_vali=2] \\
      [--n_test=120] [--lvis_eps=0.1] [--lvis_radius=1e5] [--spp=1] \\
      [--skip_lvis] [--debug] [--overwrite] [--device=cuda]

Writes under --outdir: lights.npz (lxyzs, lareas), and per view
``{train,val,test}_???/`` with metadata.json (id, imh, imw, cam_loc),
rgba.png (train and val) or nn.png (test: the nearest capture), alpha.png,
xyz.npy/.png, normal.npy/.png and lvis.npy/.png with its video. The rays
and the tracer (data_gen/raytrace.py) run on ``--device``; a view's light
visibility is one flat batch of occlusion rays from its foreground
pixels (the JAX package casts the background's too and masks them: the
same buffers).
"""

import argparse
import os
import shutil
import time
from os.path import join, basename, exists

import numpy as np
import torch

from nerfactor_tpu_torch.data_gen import camera as camlib, meshio, raytrace
from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.ops.light import gen_light_xyz
from nerfactor_tpu_torch.utils import buffers, io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="data_gen/dtu_surf")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--cam_dir', required=True)
    p.add_argument('--surf_dir', required=True)
    p.add_argument('--img_dir', required=True)
    p.add_argument('--outdir', required=True)
    p.add_argument('--mesh_path', default=None,
                   help="explicit mesh path (overrides the DTU naming "
                        "convention '<surf_dir>/<base>NNN_l3_surf_11_"
                        "trim_8.ply')")
    p.add_argument('--h', type=int, default=256)
    p.add_argument('--light_h', type=int, default=16)
    p.add_argument('--n_vali', type=int, default=2)
    p.add_argument('--n_test', type=int, default=120)
    p.add_argument('--lvis_eps', type=float, default=1e-1)
    p.add_argument('--lvis_radius', type=float, default=1e5)
    p.add_argument('--lvis_fps', type=int, default=12)
    p.add_argument('--spp', type=int, default=1)
    p.add_argument('--skip_lvis', action='store_true')
    p.add_argument('--debug', action='store_true')
    p.add_argument('--overwrite', action='store_true')
    p.add_argument('--device', default='cuda', help="torch device")
    return p.parse_args(argv)


def _resolve_mesh_path(args):
    if args.mesh_path:
        return args.mesh_path
    scene = basename(args.img_dir.rstrip('/'))
    bn = basename(args.surf_dir.rstrip('/')) \
        + '%03d' % int(scene.lstrip('scan')) + '_l3_surf_11_trim_8.ply'
    return join(args.surf_dir, bn)


def _load_view_cam(cam_path, img_hw_orig, factor):
    """DTU pos_???.txt projection matrix -> PerspCam at the working
    resolution (surf_from_mvs.py:109-121)."""
    P = np.loadtxt(cam_path).reshape(3, 4)
    K, R, c = camlib.decompose_projection(P)
    f = (K[0, 0] + K[1, 1]) / 2 / factor
    h = int(round(img_hw_orig[0] / factor))
    w = int(round(img_hw_orig[1] / factor))
    K_new = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]])
    t = -R @ c
    ext = np.concatenate([R, t[:, None]], axis=1)
    return camlib.PerspCam(K_new, ext, imh=h, imw=w)


def cast_view(cam, vertices, faces, fnormals, spp=1, device='cpu'):
    """One view's alpha, xyz and normal buffers (f32 NumPy) by casting
    ``spp`` rays a pixel on ``device``."""
    ray_dirs = cam.gen_rays(spp=spp)  # (H, W, S, 3)
    hwn = ray_dirs.shape[:3]
    dirs = torch.as_tensor(ray_dirs.reshape(-1, 3), dtype=torch.float64,
                           device=device)
    origs = torch.as_tensor(cam.loc, dtype=torch.float64,
                            device=device).expand(dirs.shape)
    hit, t, tri = raytrace.intersect(origs, dirs, vertices, faces,
                                     device=device)
    locs = origs + dirs * t.double()[:, None]
    alpha = hit.float().reshape(hwn).mean(dim=2)
    xyz = torch.where(hit[:, None], locs, torch.zeros_like(locs)).reshape(
        hwn + (3,)).mean(dim=2).float()
    normal_flat = torch.tensor([0.0, 1.0, 0.0],
                               device=device).repeat(dirs.shape[0], 1)
    normal_flat[hit] = torch.as_tensor(fnormals, device=device)[tri[hit]]
    normal = normal_flat.reshape(hwn + (3,)).mean(dim=2)
    norm = torch.linalg.norm(normal, dim=2, keepdim=True)
    normal = normal / torch.clamp(norm, min=1e-12)
    return alpha.cpu().numpy(), xyz.cpu().numpy(), normal.cpu().numpy()


def cast_lvis(xyz, alpha, normal, lxyz_flat, vertices, faces, eps,
              device='cpu'):
    """H x W x L light visibility (f32 NumPy) and the rays cast: one flat
    batch of occlusion rays from each foreground pixel's surface point to
    every light, on ``device`` (surf_from_mvs.py:282-309, without the
    per-view loop). A background pixel's visibility is 0 whatever its
    rays hit (the alpha masks it), so its rays are not cast; the JAX
    package casts them too, to keep its shapes static."""
    h, w = xyz.shape[:2]
    alpha = torch.as_tensor(alpha, device=device)
    fg = alpha > 0
    xyz = torch.as_tensor(xyz, dtype=torch.float64, device=device)[fg]
    lxyz = torch.as_tensor(lxyz_flat, dtype=torch.float64, device=device)
    dirs = lxyz[None, :, :] - xyz[:, None, :]  # (n_fg, L, 3)
    dirs = dirs / torch.clamp(torch.linalg.norm(dirs, dim=-1, keepdim=True),
                              min=1e-12)
    # March off the surface a bit to dodge self-intersection
    origs = xyz[:, None, :] + dirs * eps
    hit, _, _ = raytrace.intersect(origs.reshape(-1, 3), dirs.reshape(-1, 3),
                                   vertices, faces, any_hit_only=True,
                                   device=device)
    lvis_fg = (~hit).float().reshape(dirs.shape[:2])
    normal = torch.as_tensor(normal, dtype=torch.float64, device=device)[fg]
    lvis_fg[torch.sum(normal[:, None, :] * dirs, dim=-1) <= 0] = 0
    lvis = torch.zeros((h, w, lxyz.shape[0]), device=device)
    lvis[fg] = lvis_fg * alpha[fg][:, None]
    return lvis.cpu().numpy(), hit.numel()


def main(argv=None):
    """Writes the buffers; returns {'outdir', 'n_faces', 'views'}: per
    view its seconds (casting and writing), its tracer seconds and the
    rays it cast (camera and occlusion rays)."""
    args = parse_args(argv)
    device = torch.device(args.device)
    if args.overwrite and exists(args.outdir):
        shutil.rmtree(args.outdir)
    os.makedirs(args.outdir, exist_ok=True)

    cam_paths = ioutil.sortglob(args.cam_dir, 'pos_???', ext='txt')
    img_paths = [p for p in ioutil.sortglob(args.img_dir, '*_3_*')
                 if p.endswith('.png')]  # the most diffuse lighting
    if not img_paths:
        raise FileNotFoundError("No image globbed under %s" % args.img_dir)
    cam_paths = cam_paths[:len(img_paths)]
    if args.debug:
        img_paths, cam_paths = img_paths[:4], cam_paths[:4]
    if len(cam_paths) != len(img_paths):
        raise ValueError("Mismatch between numbers of images (%d) and poses "
                         "(%d)" % (len(img_paths), len(cam_paths)))
    n_imgs = len(img_paths)
    ind_vali = np.arange(n_imgs)[:-1:max(1, n_imgs // args.n_vali)]

    vertices, faces = meshio.read_ply(_resolve_mesh_path(args))
    fnormals = raytrace.face_normals(vertices, faces)
    mesh_center = vertices.mean(axis=0)

    # Scene-shifted light sphere, saved since it cannot be made again on
    # the fly (surf_from_mvs.py:69-83)
    lxyz, lareas = gen_light_xyz(args.light_h, 2 * args.light_h,
                                 envmap_radius=args.lvis_radius)
    lxyz = lxyz + mesh_center
    lxyz[:, :, 2] = -lxyz[:, :, 2]  # DTU's z-axis is flipped
    np.savez(join(args.outdir, 'lights.npz'), lxyzs=lxyz, lareas=lareas)
    lxyz_flat = lxyz.reshape(-1, 3)
    views = {}

    def process(view_name, cam, img=None, nn_img=None):
        t0 = time.perf_counter()
        outdir = join(args.outdir, view_name)
        os.makedirs(outdir, exist_ok=True)
        ioutil.write_json(
            {'id': view_name, 'imh': cam.imh, 'imw': cam.imw,
             'cam_loc': cam.loc.tolist()}, join(outdir, 'metadata.json'))
        if img is not None:
            ioutil.write_img(img, join(outdir, 'rgba.png'))
        if nn_img is not None:
            ioutil.write_img(nn_img, join(outdir, 'nn.png'))
        t_trace = time.perf_counter()
        alpha, xyz, normal = cast_view(cam, vertices, faces, fnormals,
                                       spp=args.spp, device=device)
        trace_s = time.perf_counter() - t_trace
        rays = alpha.size * args.spp
        buffers.write_alpha(alpha, outdir)
        buffers.write_xyz(xyz, outdir)
        buffers.write_normal(normal, outdir)
        if not args.skip_lvis:
            t_trace = time.perf_counter()
            lvis, n_rays = cast_lvis(xyz, alpha, normal, lxyz_flat, vertices,
                                     faces, args.lvis_eps, device=device)
            trace_s += time.perf_counter() - t_trace
            rays += n_rays
            buffers.write_lvis(lvis, args.lvis_fps, outdir)
        views[view_name] = {'seconds': time.perf_counter() - t0,
                            'trace_seconds': trace_s, 'rays': rays}

    # ------ Training and validation views
    cams, imgs = [], []
    factor = None
    train_i = vali_i = 0
    for i, (img_path, cam_path) in enumerate(zip(img_paths, cam_paths)):
        img = ioutil.load_img(img_path)
        if factor is None:
            factor = float(img.shape[0]) / args.h
        img_hw_orig = img.shape[:2]
        img = imgops.resize(img, new_h=args.h)
        if img.shape[2] == 3:
            img = np.dstack((img, np.ones_like(img[:, :, :1])))
        cam = _load_view_cam(cam_path, img_hw_orig, factor)
        cams.append(cam)
        imgs.append(img)
        if i in ind_vali:
            view_name = 'val_%03d' % vali_i
            vali_i += 1
        else:
            view_name = 'train_%03d' % train_i
            train_i += 1
        logger.info("Casting %s", view_name)
        process(view_name, cam, img=img)

    # ------ Test trajectory: a lat-lng sweep around the scene center
    cam_locs = np.stack([c.loc for c in cams])
    cam_dist = 1.5 * np.mean(np.linalg.norm(cam_locs - mesh_center, axis=1))
    n_test = 4 if args.debug else args.n_test
    lngs = np.linspace(-0.25 * np.pi, 0.5 * np.pi, args.n_test // 2)
    lngs = np.hstack((lngs, np.linspace(
        0.5 * np.pi, -0.25 * np.pi, args.n_test - len(lngs))))[:n_test]
    lats = np.linspace(-0.25 * np.pi, 0, args.n_test)[:n_test]
    K = cams[0].int_mat
    for i, (lat, lng) in enumerate(zip(lats, lngs)):
        loc = cam_dist * np.array([
            np.cos(lat) * np.cos(lng), np.cos(lat) * np.sin(lng),
            np.sin(lat)]) + mesh_center
        cam = camlib.PerspCam.from_lookat(
            K, loc, mesh_center, up=(0, 0, -1),  # DTU up is -z
            imh=cams[0].imh, imw=cams[0].imw)
        nn = imgs[int(np.argmin(np.linalg.norm(loc - cam_locs, axis=1)))]
        logger.info("Casting test_%03d", i)
        process('test_%03d' % i, cam, nn_img=nn)
    logger.info("Done: %s", args.outdir)
    return {'outdir': args.outdir, 'n_faces': len(faces), 'views': views}


if __name__ == '__main__':
    main()
