"""Synthetic-scene rendering with Blender Cycles: per view renders
rgba.png, relit ground truth under test HDRs + OLATs, albedo.png
(diffuse + optional glossy color passes), normal.png (+ reference
ball), and writes metadata.json.

Counterpart of data_gen_tpu/nerf_synth_render.py, on the port's image,
EXR and light IO. CLI parity with data_gen/nerf_synth/render.py (run
inside Blender's bundled Python):
  blender --background --python nerf_synth_render.py -- \
      --scene_path=... --cam_dir=... --light_path=... --outdir=... \
      [--light_inten=3] [--res=512] [--spp=128] [--test_light_dir=...]
      [--add_glossy_albedo] [--vali_first_n=8] [--debug]

This image has no Blender, so the bpy-dependent body is gated: the
metadata/json/nearest-neighbor machinery (pure NumPy) is importable and
tested; invoking the renderer without bpy raises a clear error.
"""

import argparse
import json
import os
from os.path import join, basename, exists

import numpy as np

from nerfactor_tpu_torch.ops import img as imgops
from nerfactor_tpu_torch.ops.light import load_light
from nerfactor_tpu_torch.utils import exr as exrutil, io as ioutil
from nerfactor_tpu_torch.utils.logging import Logger

logger = Logger(loggee="data_gen/nerf_synth")

try:
    import bpy  # only inside Blender's Python
    HAS_BPY = True
except ImportError:
    HAS_BPY = False


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument('--scene_path', required=True, help=".blend file")
    p.add_argument('--cam_dir', required=True,
                   help="dir of transforms_{train,val,test}.json")
    p.add_argument('--light_path', required=True, help="training envmap")
    p.add_argument('--light_inten', type=float, default=3.0)
    p.add_argument('--test_light_dir', default=None)
    p.add_argument('--res', type=int, default=512)
    p.add_argument('--spp', type=int, default=128)
    p.add_argument('--add_glossy_albedo', action='store_true')
    p.add_argument('--vali_first_n', type=int, default=None)
    p.add_argument('--outdir', required=True)
    p.add_argument('--debug', action='store_true')
    p.add_argument('--overwrite', action='store_true')
    return p.parse_args(argv)


def write_view_metadata(outdir, cam_transform_mat, cam_angle_x, scene,
                        envmap, envmap_inten, res, spp):
    """metadata.json with the exact keys the datasets parse
    (reference render.py:116-127)."""
    mat = np.asarray(cam_transform_mat, float).reshape(4, 4)
    data = {
        'scene': scene,
        'cam_transform_mat': ','.join(str(x) for x in mat.ravel()),
        'cam_angle_x': cam_angle_x, 'envmap': envmap,
        'envmap_inten': envmap_inten, 'imh': res, 'imw': res, 'spp': spp}
    ioutil.write_json(data, join(outdir, 'metadata.json'))
    return data


def relabel_transforms(cams_json, mode, outdir, vali_first_n=None,
                       debug=False):
    """Rewrites frame file_paths to ./<mode>_<i>/rgba (JaxNeRF interop)
    and returns the frames to render (reference render.py:45-63)."""
    with open(cams_json) as h:
        data = json.load(h)
    frames = data['frames']
    if mode == 'val' and vali_first_n is not None:
        frames = frames[:vali_first_n]
    if debug:
        frames = frames[:1]
    out = {'camera_angle_x': data['camera_angle_x'], 'frames': []}
    for i, frame in enumerate(frames):
        frame = dict(frame)
        frame['file_path'] = './%s_%03d/rgba' % (mode, i)
        out['frames'].append(frame)
    with open(join(outdir, 'transforms_%s.json' % mode), 'w') as h:
        json.dump(out, h, indent=4)
    return out['camera_angle_x'], out['frames']


def save_test_nearest_inputs(outdir, light_path, light_inten=None):
    """For each test view, composites the nearest train/vali input onto
    the average-light background with a probe inset
    (reference render.py:72-110)."""
    del light_inten
    with open(join(outdir, 'transforms_train.json')) as h:
        train_cams = json.load(h)['frames']
    with open(join(outdir, 'transforms_val.json')) as h:
        vali_cams = json.load(h)['frames']
    with open(join(outdir, 'transforms_test.json')) as h:
        test_cams = json.load(h)['frames']
    train_vali = train_cams + vali_cams
    train_vali_trans = np.vstack([
        np.array(x['transform_matrix'])[:3, 3] for x in train_vali])
    light = load_light(light_path)
    light = np.power(np.clip(light / max(light.max(), 1e-12), 0, 1),
                     1 / 4)  # gamma-4 tonemap
    avg_light = np.mean(light[:light.shape[0] // 2], axis=(0, 1),
                        keepdims=True)
    for test_cam in test_cams:
        test_trans = np.array(test_cam['transform_matrix'])[:3, 3]
        nn_i = int(np.argmin(np.linalg.norm(
            test_trans - train_vali_trans, axis=1)))
        nn_id = train_vali[nn_i]['file_path'].split('/')[-2]
        nn = ioutil.load_img(join(outdir, nn_id, 'rgba.png'),
                             force_rgba=True)
        comp = imgops.alpha_blend(
            nn[:, :, :3], nn[:, :, 3],
            np.tile(avg_light, nn.shape[:2] + (1,)))
        light_vis_h = max(1, int(32 / 256 * comp.shape[0]))
        thumb = imgops.resize(light, new_h=light_vis_h)
        comp[:thumb.shape[0], -thumb.shape[1]:] = thumb
        test_id = test_cam['file_path'].split('/')[-2]
        ioutil.write_img(comp, join(outdir, test_id, 'nn.png'))


def main(argv=None):
    args = parse_args(argv)
    if not HAS_BPY:
        raise SystemExit(
            "nerf_synth_render drives Blender Cycles and must run inside "
            "Blender's Python:\n  blender --background --python %s -- "
            "<flags>\n(bpy is not importable in this interpreter)"
            % __file__)
    os.makedirs(args.outdir, exist_ok=True)
    for cams_json in ioutil.sortglob(args.cam_dir, ext='json'):
        mode = basename(cams_json)[:-len('.json')].split('_')[-1]
        cam_angle_x, frames = relabel_transforms(
            cams_json, mode, args.outdir,
            vali_first_n=args.vali_first_n, debug=args.debug)
        for i, frame in enumerate(frames):
            outdir = join(args.outdir, '%s_%03d' % (mode, i))
            _render_view(args, frame['transform_matrix'], cam_angle_x,
                         outdir)
    save_test_nearest_inputs(args.outdir, args.light_path)


def _render_view(args, cam_transform_mat, cam_angle_x, outdir):
    """Blender-side body (reference render.py:113-247): open scene,
    strip lights/trackers, pose the camera, render RGBA + relit GTs +
    albedo/normal passes."""
    from mathutils import Matrix  # Blender-bundled

    os.makedirs(outdir, exist_ok=True)
    if not exists(join(outdir, 'metadata.json')):
        write_view_metadata(
            outdir, cam_transform_mat, cam_angle_x,
            basename(args.scene_path), basename(args.light_path),
            args.light_inten, args.res, args.spp)
    bpy.ops.wm.open_mainfile(filepath=args.scene_path)
    # Strip empties (pose trackers), background planes, and lights
    doomed = [o for o in bpy.data.objects
              if (o.type == 'EMPTY' and 'Empty' in o.name)
              or o.name == 'BackgroundPlane' or o.type == 'LIGHT']
    for o in bpy.data.objects:
        if o.active_material is not None:
            for node in o.active_material.node_tree.nodes:
                if node.type == 'EMISSION':
                    doomed.append(o)
    bpy.ops.object.delete({'selected_objects': doomed})
    cam_obj = bpy.data.objects['Camera']
    cam_obj.data.sensor_width = args.res
    cam_obj.data.sensor_height = args.res
    cam_obj.data.lens = 0.5 * args.res / np.tan(0.5 * cam_angle_x)
    cam_obj.matrix_world = Matrix(
        np.asarray(cam_transform_mat, float).reshape(4, 4))
    bpy.context.view_layer.update()
    _set_env_light(args.light_path, args.light_inten)
    scene = bpy.context.scene
    scene.render.resolution_x = args.res
    scene.render.resolution_y = args.res
    scene.cycles.samples = args.spp
    scene.render.film_transparent = True
    rgba_png = join(outdir, 'rgba.png')
    if not exists(rgba_png):
        scene.render.filepath = rgba_png
        bpy.ops.render.render(write_still=True)
    if args.test_light_dir:
        for envmap_path in ioutil.sortglob(args.test_light_dir,
                                           ext='hdr'):
            name = basename(envmap_path).split('.')[0]
            outpath = join(outdir, 'rgba_%s.png' % name)
            if exists(outpath):
                continue
            _set_env_light(envmap_path, 1.0)
            scene.render.filepath = outpath
            bpy.ops.render.render(write_still=True)
        for olat_json in ioutil.sortglob(args.test_light_dir,
                                         ext='json'):
            name = basename(olat_json).split('.')[0]
            outpath = join(outdir, 'rgba_%s.png' % name)
            if exists(outpath):
                continue
            olat = ioutil.read_json(olat_json)
            _set_env_light(None, 0.0)
            light_data = bpy.data.lights.new('olat', type='POINT')
            light_data.energy = 50_000
            light_obj = bpy.data.objects.new('olat', light_data)
            light_obj.location = olat['point_location']
            bpy.context.collection.objects.link(light_obj)
            scene.render.filepath = outpath
            bpy.ops.render.render(write_still=True)
            bpy.data.objects.remove(light_obj)
    # Albedo: Cycles diffuse-color pass (white specularity assumption),
    # plus the glossy-color pass when requested (reference
    # render.py:215-233)
    albedo_png = join(outdir, 'albedo.png')
    if not exists(albedo_png):
        rgba = ioutil.load_img(rgba_png, force_rgba=True)
        alpha = rgba[:, :, 3]
        diffuse_exr = join(outdir, 'diffuse-color.exr')
        _render_pass_exr(scene, diffuse_exr, 'diffuse_color')
        albedo = exrutil.read_exr(diffuse_exr)[:, :, :3]
        if args.add_glossy_albedo:
            glossy_exr = join(outdir, 'glossy-color.exr')
            _render_pass_exr(scene, glossy_exr, 'glossy_color')
            albedo = albedo + exrutil.read_exr(glossy_exr)[:, :, :3]
        ioutil.write_img(np.dstack((albedo, alpha)), albedo_png)
    # World-space normals via the Cycles normal pass, plus the
    # reference ball (reference render.py:235-247)
    normal_png = join(outdir, 'normal.png')
    if not exists(normal_png):
        rgba = ioutil.load_img(rgba_png, force_rgba=True)
        alpha = rgba[:, :, 3]
        samples_old = scene.cycles.samples
        scene.cycles.samples = 16  # anti-aliased edges only
        normal_exr = join(outdir, 'normal.exr')
        refball_exr = join(outdir, 'refball-normal.exr')
        refball = _add_refball(cam_obj, args.res)
        hidden = {}
        for o in bpy.data.objects:
            if o.type == 'MESH':
                hidden[o.name] = o.hide_render
                o.hide_render = o.name != refball.name
        _render_pass_exr(scene, refball_exr, 'normal')
        for name, state in hidden.items():
            bpy.data.objects[name].hide_render = state
        bpy.data.objects.remove(refball)
        _render_pass_exr(scene, normal_exr, 'normal')
        scene.cycles.samples = samples_old
        normals = exrutil.read_exr(normal_exr)[:, :, :3]
        ioutil.write_img(
            np.dstack((_normal_as_image(normals), alpha)), normal_png)
        refball_normals = exrutil.read_exr(refball_exr)
        ioutil.write_img(
            np.dstack((_normal_as_image(refball_normals[:, :, :3]),
                       refball_normals[:, :, 3]
                       if refball_normals.shape[2] > 3 else
                       np.ones(refball_normals.shape[:2], np.float32))),
            join(outdir, 'refball-normal.png'))


def _normal_as_image(normals):
    """(H, W, 3) world normals in [-1, 1] -> displayable [0, 1] RGB
    (xiuminglib vis.geometry.normal_as_image semantics)."""
    return np.clip((np.asarray(normals, np.float32) + 1.0) / 2.0, 0.0, 1.0)


def _render_pass_exr(scene, outpath, pass_name):
    """Renders ONE Cycles view-layer pass (alpha-carrying 32-bit EXR)
    through a compositor FileOutput node (the reference's
    xiuminglib/blender/render.py:618-699 flow, re-expressed minimally:
    enable the pass, SetAlpha it with the render alpha, file-output the
    socket, render, move the frame-numbered file into place)."""
    import shutil
    import tempfile

    pass_sockets = {'diffuse_color': 'DiffCol', 'glossy_color': 'GlossCol',
                    'normal': 'Normal'}
    socket = pass_sockets[pass_name]
    view_layer = bpy.context.view_layer
    setattr(view_layer, 'use_pass_' + pass_name, True)
    film_old = scene.render.film_transparent
    use_nodes_old = scene.use_nodes
    scene.render.film_transparent = True
    scene.use_nodes = True
    tree = scene.node_tree
    tmpdir = tempfile.mkdtemp(prefix='pass_')
    added_nodes = []
    try:
        for node in list(tree.nodes):
            if node.name != 'Render Layers':
                tree.nodes.remove(node)
        if 'Render Layers' not in tree.nodes:
            tree.nodes.new('CompositorNodeRLayers')
        rl = tree.nodes['Render Layers']
        set_alpha = tree.nodes.new('CompositorNodeSetAlpha')
        added_nodes.append(set_alpha)
        tree.links.new(rl.outputs['Alpha'], set_alpha.inputs['Alpha'])
        tree.links.new(rl.outputs[socket], set_alpha.inputs['Image'])
        outnode = tree.nodes.new('CompositorNodeOutputFile')
        added_nodes.append(outnode)
        outnode.base_path = tmpdir + os.sep
        outnode.format.file_format = 'OPEN_EXR'
        outnode.format.color_depth = '32'
        outnode.format.color_mode = 'RGBA'
        tree.links.new(set_alpha.outputs['Image'],
                       outnode.inputs['Image'])
        scene.render.filepath = join(tmpdir, 'composite_discard')
        bpy.ops.render.render(write_still=True)
        frames = sorted(f for f in os.listdir(tmpdir)
                        if f.endswith('.exr'))
        if not frames:
            raise RuntimeError("FileOutput node wrote no EXR frame")
        shutil.move(join(tmpdir, frames[0]), outpath)
    finally:
        # Leave no dangling SetAlpha/FileOutput tree behind: a regular
        # render issued after this call would otherwise composite
        # through it and write a wrong/black still
        for node in added_nodes:
            tree.nodes.remove(node)
        scene.use_nodes = use_nodes_old
        scene.render.film_transparent = film_old
        shutil.rmtree(tmpdir, ignore_errors=True)
    return outpath


def _add_refball(cam_obj, res):
    """Adds a smooth-shaded UV sphere centered on the optical axis at
    depth 10, scaled so its projection spans ~80% of the frame
    (reference render.py:241 via xiuminglib render_normal's refball)."""
    from mathutils import Vector

    z_c = 10.0
    center = cam_obj.matrix_world @ Vector((0.0, 0.0, -z_c))
    # Projected radius fraction of the half-frame is r * lens /
    # (z * sensor/2); solve for 0.8
    sensor = cam_obj.data.sensor_width
    radius = 0.8 * z_c * sensor / (2.0 * cam_obj.data.lens)
    bpy.ops.mesh.primitive_uv_sphere_add(
        radius=radius, location=tuple(center))
    sphere = bpy.context.object
    sphere.name = 'refball'
    for f in sphere.data.polygons:
        f.use_smooth = True
    return sphere


def _set_env_light(path, strength):
    world = bpy.context.scene.world
    world.use_nodes = True
    nodes = world.node_tree.nodes
    nodes.clear()
    bg = nodes.new('ShaderNodeBackground')
    out = nodes.new('ShaderNodeOutputWorld')
    world.node_tree.links.new(bg.outputs['Background'],
                              out.inputs['Surface'])
    bg.inputs['Strength'].default_value = strength
    if path:
        env = nodes.new('ShaderNodeTexEnvironment')
        env.image = bpy.data.images.load(path)
        world.node_tree.links.new(env.outputs['Color'],
                                  bg.inputs['Color'])


if __name__ == '__main__':
    import sys
    argv = sys.argv
    if '--' in argv:
        argv = argv[argv.index('--') + 1:]
    else:
        argv = argv[1:]
    main(argv)
