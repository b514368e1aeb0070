"""Writers of the distilled-geometry buffers that geometry_from_nerf writes
and the shape and joint datasets read (counterpart of
nerfactor_tpu/utils/buffers.py, on the port's PNG writer and video).

Per view directory, as the reference (geometry_from_nerf.py:107-111,
util/geom.py:27-79): alpha.png, xyz.npy + xyz.png, normal.npy +
normal.png, lvis.npy + lvis.png + lvis.mp4 (lvis.apng where no video
backend is importable).
"""

from os.path import join

import numpy as np

from nerfactor_tpu_torch.utils import io as ioutil, vis as visutil


def write_lvis(lvis, fps, out_dir, dtype=np.float32):
    """``dtype=np.float16`` halves the largest buffer (H x W x 512) on
    disk; the loaders take either (values lie in [0, 1]). f32 is the
    reference's."""
    ioutil.save_np(np.asarray(lvis).astype(dtype), join(out_dir, 'lvis.npy'))
    ioutil.write_img(np.mean(lvis, axis=2), join(out_dir, 'lvis.png'))
    frames = []
    for i in range(lvis.shape[2]):
        frame = (np.clip(lvis[:, :, i], 0, 1) * 255).astype(np.uint8)
        frames.append(np.dstack([frame] * 3))
    visutil.make_video(frames, join(out_dir, 'lvis.mp4'), fps=fps)


def write_xyz(xyz, out_dir):
    xyz = np.asarray(xyz)
    ioutil.save_np(xyz.astype(np.float32), join(out_dir, 'xyz.npy'))
    rng = xyz.max() - xyz.min()
    norm = (xyz - xyz.min()) / (rng if rng > 0 else 1.0)
    ioutil.write_img(norm, join(out_dir, 'xyz.png'))


def write_normal(normal, out_dir):
    normal = np.asarray(normal)
    ioutil.save_np(normal.astype(np.float32), join(out_dir, 'normal.npy'))
    ioutil.write_img((normal + 1) / 2, join(out_dir, 'normal.png'))


def write_alpha(alpha, out_dir):
    ioutil.write_img(np.asarray(alpha), join(out_dir, 'alpha.png'))
