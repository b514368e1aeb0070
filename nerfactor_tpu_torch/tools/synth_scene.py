"""The analytic-sphere scene on NumPy (counterpart of tests/synth.py, on
the port's own light sphere and PNG writer).

Views are laid out as the reference's Blender renders: per view a
'<mode>_???' folder with metadata.json (cam_transform_mat, cam_angle_x,
imh, imw) and, for train and val views, rgba.png and the ground-truth
albedo.png; optionally the geometry buffers that geometry_from_nerf would
write (xyz.npy, normal.npy, lvis.npy, alpha.png), computed exactly from
the sphere, so the shape and joint stages train without a NeRF.
"""

import json
import os
from os.path import join

import numpy as np

from nerfactor_tpu_torch.ops.light import gen_light_xyz
from nerfactor_tpu_torch.utils import io as ioutil

SPHERE_R = 0.8
CAM_DIST = 4.0
ANGLE_X = 0.6911112070083618  # as the synthetic NeRF scenes
ALBEDO = (0.6, 0.3, 0.2)


def look_at_c2w(cam_loc, target=(0.0, 0.0, 0.0), up=(0.0, 0.0, 1.0)):
    """Camera-to-world in the Blender/NeRF convention: camera x right, y
    up, z backward (rays go through -z)."""
    cam_loc = np.asarray(cam_loc, float)
    fwd = np.asarray(target, float) - cam_loc
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, float))
    right /= np.linalg.norm(right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = np.cross(right, fwd)
    c2w[:3, 2] = -fwd
    c2w[:3, 3] = cam_loc
    return c2w


def ring_cameras(n, elev_deg=30.0, dist=CAM_DIST, phase=0.0):
    """``n`` cameras evenly around a ring at ``elev_deg``, looking at the
    origin."""
    el = np.deg2rad(elev_deg)
    cams = []
    for i in range(n):
        az = phase + 2 * np.pi * i / n
        cams.append(look_at_c2w(dist * np.array([
            np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])))
    return cams


def gen_rays(c2w, imh, imw, angle_x=ANGLE_X):
    """Per-pixel ray origins and (unnormalized) directions, (H, W, 3)."""
    xs, ys = np.meshgrid(np.linspace(0, imw, imw, endpoint=False),
                         np.linspace(0, imh, imh, endpoint=False))
    fl = 0.5 * imw / np.tan(0.5 * angle_x)
    rayd_local = np.stack(
        ((xs - 0.5 * imw) / fl, -(ys - 0.5 * imh) / fl, -np.ones_like(xs)),
        axis=-1)
    rayd = np.sum(rayd_local[:, :, None, :] * c2w[:3, :3], axis=-1)
    rayo = np.tile(c2w[:3, 3][None, None, :], (imh, imw, 1))
    return rayo, rayd


def ray_sphere(rayo, rayd, r=SPHERE_R):
    """(hit mask, first-hit distance, unit directions)."""
    d = rayd / np.linalg.norm(rayd, axis=-1, keepdims=True)
    b = np.sum(rayo * d, axis=-1)
    c = np.sum(rayo * rayo, axis=-1) - r ** 2
    disc = b ** 2 - c
    t = -b - np.sqrt(np.maximum(disc, 0))
    hit = (disc > 0) & (t > 0)
    return hit, t, d


def shade(xyz, normal, albedo_rgb=ALBEDO, light_dir=(0.5, 0.5, 1)):
    """Lambertian under one directional light plus a 0.25 ambient."""
    l = np.asarray(light_dir, float)
    l /= np.linalg.norm(l)
    lambert = np.clip(normal @ l, 0, 1)
    ambient = 0.25
    rgb = np.asarray(albedo_rgb)[None, None, :] * (
        ambient + (1 - ambient) * lambert[..., None])
    return np.clip(rgb, 0, 1)


def sphere_lvis(xyz, normal, light_h=4):
    """Exact light visibility of a convex sphere: a light is visible where
    it lies in front of the surface."""
    lxyz = gen_light_xyz(light_h, 2 * light_h)[0].reshape(-1, 3)
    surf2l = lxyz[None, None, :, :] - xyz[:, :, None, :]
    surf2l /= np.linalg.norm(surf2l, axis=-1, keepdims=True)
    cos = np.einsum('hwlc,hwc->hwl', surf2l, normal)
    return (cos > 0).astype(np.float32)


def write_view(view_dir, c2w, imh, imw, with_rgba=True, light_h=4,
               with_buffers=False, nerf_root=None, view_id=None):
    """One view's metadata.json, rgba.png and albedo.png (``with_rgba``)
    and its buffers under ``<nerf_root>/<view_id>`` (``with_buffers``)."""
    os.makedirs(view_dir, exist_ok=True)
    metadata = {
        'cam_transform_mat': ','.join(str(x) for x in c2w.ravel()),
        'cam_angle_x': ANGLE_X,
        'imh': imh, 'imw': imw, 'spp': 1,
        'scene': 'synth_sphere', 'split': os.path.basename(view_dir),
    }
    with open(join(view_dir, 'metadata.json'), 'w') as h:
        json.dump(metadata, h)
    rayo, rayd = gen_rays(c2w, imh, imw)
    hit, t, d = ray_sphere(rayo, rayd)
    xyz = rayo + d * t[..., None]
    xyz[~hit] = 0.0
    normal = xyz / SPHERE_R
    normal[~hit] = np.array([0.0, 1.0, 0.0])
    alpha = hit.astype(np.float32)
    if with_rgba:
        rgb = shade(xyz, normal)
        rgb[~hit] = 0.0
        ioutil.write_img(np.dstack([rgb, alpha]), join(view_dir, 'rgba.png'))
        # Ground-truth albedo, gamma-encoded, for test.py's color correction
        albedo = np.zeros_like(rgb)
        albedo[hit] = ALBEDO
        ioutil.write_img(np.dstack([albedo ** (1 / 2.2), alpha]),
                         join(view_dir, 'albedo.png'))
    if with_buffers:
        buf_dir = join(nerf_root, view_id)
        ioutil.save_np(xyz.astype(np.float32), join(buf_dir, 'xyz.npy'))
        ioutil.save_np(normal.astype(np.float32), join(buf_dir, 'normal.npy'))
        lvis = sphere_lvis(xyz, normal, light_h=light_h)
        lvis[~hit] = 0.0
        ioutil.save_np(lvis, join(buf_dir, 'lvis.npy'))
        ioutil.write_img(alpha, join(buf_dir, 'alpha.png'))


def make_scene(root, n_train=4, n_vali=2, n_test=2, imh=16,
               with_buffers=False, nerf_root=None, light_h=4):
    """A whole scene: train, val and test views on three camera rings (no
    rgba.png for the test views); returns (root, nerf_root), the buffers
    under ``<root>/surf`` unless ``nerf_root`` says otherwise."""
    if with_buffers and nerf_root is None:
        nerf_root = join(root, 'surf')
    specs = [('train', n_train, 10.0), ('val', n_vali, 40.0),
             ('test', n_test, 70.0)]
    for mode, n, phase_deg in specs:
        for i, c2w in enumerate(ring_cameras(n, phase=np.deg2rad(phase_deg))):
            vid = '%s_%03d' % (mode, i)
            write_view(join(root, vid), c2w, imh, imh,
                       with_rgba=mode != 'test', light_h=light_h,
                       with_buffers=with_buffers, nerf_root=nerf_root,
                       view_id=vid)
    return root, nerf_root
