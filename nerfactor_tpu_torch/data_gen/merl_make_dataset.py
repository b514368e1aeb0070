"""Converts downloaded MERL .binary BRDFs into the framework's npz
tables + visualization renders (counterpart of
data_gen_tpu/merl_make_dataset.py, on the port's MERL reader and sphere
renderer; runs on the host).

CLI parity with the reference's data_gen/merl/make_dataset.py:
  python -m nerfactor_tpu_torch.data_gen.merl_make_dataset \\
      --indir=/path/to/merl/binaries --outdir=/out \\
      [--vali_frac=0.01] [--envmap_path=point] [--envmap_h=16]
      [--envmap_inten=40] [--slice_percentile=80] [--ims=128] [--spp=1]
      [--overwrite]

Outputs per material: train_<name>.npz / vali_<name>.npz with (rusink,
luminance-reflectance) rows; one shared test.npz whose rusink rows are
the characteristic-slice coordinates followed by the sphere-render
coordinates (reference make_dataset.py:54-69); and vis/ renders. The
files are the JAX converter's. The render's Rusinkiewicz coordinates
depend on the renderer alone, so they are computed once for the test
table and every material, and each material's table is queried once for
its color and achromatic renders. ``main`` returns the materials and the
seconds taken.
"""

import argparse
import os
import shutil
from os.path import join, exists
from time import perf_counter

import numpy as np

from nerfactor_tpu_torch.brdf import merl
from nerfactor_tpu_torch.brdf.renderer import SphereRenderer
from nerfactor_tpu_torch.ops.img import rgb2lum
from nerfactor_tpu_torch.utils import io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="data_gen/merl")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--indir', required=True,
                   help="directory of downloaded MERL .binary files")
    p.add_argument('--vali_frac', type=float, default=0.01)
    p.add_argument('--envmap_path', default='point')
    p.add_argument('--envmap_h', type=int, default=16)
    p.add_argument('--envmap_inten', type=float, default=40.0)
    p.add_argument('--slice_percentile', type=float, default=80)
    p.add_argument('--ims', type=int, default=128,
                   help="render size during visualization")
    p.add_argument('--spp', type=int, default=1)
    p.add_argument('--outdir', required=True)
    p.add_argument('--overwrite', action='store_true')
    return p.parse_args(argv)


def make_test_table(render_rusink, outdir, envmap_h, ims, spp):
    """Shared test queries: characteristic slice then the render's lit
    foreground pairs (``render_rusink``)."""
    cslice_rusink = merl.characteristic_slice_rusink().reshape(-1, 3)
    qrusink = np.vstack((cslice_rusink, render_rusink))
    data = {'envmap_h': envmap_h, 'ims': ims, 'spp': spp,
            'rusink': qrusink.astype(np.float32)}
    ioutil.save_npz(data, join(outdir, 'test.npz'))


def convert_material(path, i, renderer, render_rusink, args):
    """One material's train/vali tables and its four visualizations;
    ``render_rusink`` holds the coordinates of the renderer's lit
    foreground pairs."""
    brdf = merl.MERL(path)
    rusink = brdf.tbl[:, :3]
    refl = rgb2lum(brdf.tbl[:, 3:])[:, None]
    n = brdf.tbl.shape[0]
    take_every = int(1 / args.vali_frac)
    vali_ind = np.arange(0, n, take_every, dtype=int)
    train_mask = np.ones(n, bool)
    train_mask[vali_ind] = False
    common = {'i': i, 'name': brdf.name, 'envmap_h': args.envmap_h,
              'ims': args.ims, 'spp': args.spp}
    ioutil.save_npz(
        dict(common, rusink=rusink[train_mask].astype(np.float32),
             refl=refl[train_mask].astype(np.float32)),
        join(args.outdir, 'train_%s.npz' % brdf.name))
    ioutil.save_npz(
        dict(common, rusink=rusink[vali_ind].astype(np.float32),
             refl=refl[vali_ind].astype(np.float32)),
        join(args.outdir, 'vali_%s.npz' % brdf.name))
    # Visualization: characteristic slices + sphere renders, color and
    # achromatic
    vis_dir = join(args.outdir, 'vis')
    lvis = renderer.lvis.astype(bool)
    rgb_lit = brdf.query(render_rusink)
    for achro in (False, True):
        cslice = brdf.get_characterstic_slice()
        if achro:
            cslice = np.tile(rgb2lum(cslice)[:, :, None], (1, 1, 3))
        cslice_img = merl.characteristic_slice_as_img(
            cslice, clip_percentile=args.slice_percentile)
        folder = 'cslice_achromatic' if achro else 'cslice'
        ioutil.write_img(cslice_img,
                         join(vis_dir, folder, brdf.name + '.png'))
        rgb = np.zeros_like(renderer.lcontrib)
        rgb[lvis] = rgb_lit
        if achro:
            rgb = np.tile(rgb2lum(rgb)[..., None], (1, 1, 1, 3))
        render = renderer.render(rgb)
        folder = 'render_achromatic' if achro else 'render'
        ioutil.write_img(np.clip(render, 0, 1),
                         join(vis_dir, folder, brdf.name + '.png'))
    return brdf.name


def main(argv=None):
    args = parse_args(argv)
    t0 = perf_counter()
    if args.overwrite and exists(args.outdir):
        shutil.rmtree(args.outdir)
    os.makedirs(args.outdir, exist_ok=True)
    renderer = SphereRenderer(
        args.envmap_path, args.outdir, envmap_inten=args.envmap_inten,
        envmap_h=args.envmap_h, ims=args.ims, spp=args.spp)
    render_rusink = merl.dir2rusink(renderer.ldir, renderer.vdir)[
        renderer.lvis.astype(bool)]
    make_test_table(render_rusink, args.outdir, args.envmap_h, args.ims,
                    args.spp)
    brdf_paths = [p for p in ioutil.sortglob(args.indir)
                  if p.endswith('.binary')]
    if not brdf_paths:
        raise FileNotFoundError("No .binary MERL file under %s" % args.indir)
    logger.info("Converting %d MERL materials", len(brdf_paths))
    t_setup = perf_counter() - t0
    names = [convert_material(path, i, renderer, render_rusink, args)
             for i, path in enumerate(brdf_paths)]
    logger.info("Done: %s", args.outdir)
    seconds = perf_counter() - t0
    return {'outdir': args.outdir, 'materials': names,
            'test_rows': int(render_rusink.shape[0]
                             + np.prod(merl.BRDF_SHAPE[1:])),
            'setup_seconds': t_setup, 'seconds': seconds,
            's_per_material': (seconds - t_setup) / len(names)}


if __name__ == '__main__':
    main()
