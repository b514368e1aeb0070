"""The port's test-mode video compile vs the JAX package (CPU).

  * ``to_uint``, ``srgb2linear``, ``rgb2lum``, ``hconcat``, ``vconcat``
    and ``make_frame`` against the JAX functions on seeded inputs;
  * the joint model's ``compile_batch_vis(mode='test')`` on one
    ``vis_test`` tree (written by the port's test.py from a JAX-written
    checkpoint): the frames both packages hand to ``make_video``, the
    novel-light thumbnails embedded in them, and the path returned;
  * the NeRF model's, on seeded fine renders, one view beside a nearest
    real capture of another size;
  * the APNG a video falls back to without PIL decodes to its frames.
"""

import os
import subprocess
import sys
from os.path import join

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image, ImageSequence

from nerfactor_tpu.models.nerf import Model as JNeRFModel
from nerfactor_tpu.models.nerfactor import Model as JModel
from nerfactor_tpu.ops import img as jimg
from nerfactor_tpu.utils import vis as jvis
from nerfactor_tpu_torch import test as ttest
from nerfactor_tpu_torch.models.nerf import Model as TNeRFModel
from nerfactor_tpu_torch.models.nerfactor import Model as TModel
from nerfactor_tpu_torch.ops import img as timg
from nerfactor_tpu_torch.utils import io as tio, vis as tvis
from tests.test_torch_nerfactor import (
    IMH, LIGHT_H, REPO, _experiment, build_scene, make_joint)

# Frames hold 8-bit pixels; a resize (torch's antialiased bilinear
# against jax.image.resize) may truncate one level apart
FRAME_TOL = 1


def seeded_imgs(seed):
    rng = np.random.RandomState(seed)
    return [rng.rand(6, 10, 3).astype(np.float32),
            rng.rand(9, 4).astype(np.float32),  # gray, another height
            (rng.rand(6, 5, 3) * 255).astype(np.uint8).astype(np.float32)
            / 255]


def test_image_ops_match_jax():
    rng = np.random.RandomState(0)
    x = (rng.rand(7, 5, 3) * 1.4 - 0.2).astype(np.float32)
    for dtype in (np.uint8, np.uint16):
        got, want = timg.to_uint(x, dtype), jimg.to_uint(x, dtype)
        assert got.dtype == want.dtype and np.array_equal(got, want)
    np.testing.assert_array_equal(timg.srgb2linear(x), jimg.srgb2linear(x))
    np.testing.assert_allclose(
        timg.srgb2linear(torch.from_numpy(x)).numpy(),
        np.asarray(jimg.srgb2linear(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(timg.rgb2lum(x), jimg.rgb2lum(x))
    np.testing.assert_allclose(
        timg.rgb2lum(torch.from_numpy(x)).numpy(),
        np.asarray(jimg.rgb2lum(jnp.asarray(x))), rtol=1e-6, atol=1e-7)
    imgs = seeded_imgs(1)
    for fn, kw in ((timg.hconcat, {}), (timg.hconcat, {'out_w': 13}),
                   (timg.vconcat, {}), (timg.vconcat, {'out_h': 11})):
        ims = imgs if fn is timg.hconcat else [im.transpose(1, 0, 2)
                                                if im.ndim == 3 else im.T
                                                for im in imgs]
        got = fn(ims, **kw)
        want = getattr(jimg, fn.__name__)(ims, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def write_batch_dir(batch_dir, names, seed, hw=(8, 8)):
    rng = np.random.RandomState(seed)
    for name in names:
        tio.write_img(rng.rand(*hw, 3), join(batch_dir, 'pred_%s.png' % name))


@pytest.mark.parametrize('with_nn', [False, True])
def test_make_frame_matches_jax(tmp_path, with_nn):
    batch_dir = str(tmp_path / 'batch000000000')
    write_batch_dir(batch_dir, ('normal', 'lvis', 'brdf', 'albedo', 'rgb'), 3)
    data_root = str(tmp_path / 'data')
    if with_nn:  # a real capture of another size
        tio.write_img(np.random.RandomState(4).rand(12, 10, 3),
                      join(data_root, 'test_phys_nn', 'test_000_nn_000.png'))
    light = (np.random.RandomState(5).rand(16, 32, 3) * 255).astype(np.uint8)
    layout = (('normal', 'lvis', 'nn'), ('brdf', 'albedo', 'rgb'))
    for kw in ({}, {'rgb_embed_light': light}):
        got = tvis.make_frame(batch_dir, layout, data_root=data_root, **kw)
        want = jvis.make_frame(batch_dir, layout, data_root=data_root, **kw)
        assert got.shape == want.shape and got.dtype == want.dtype
        assert np.abs(got.astype(int) - want).max() <= FRAME_TOL
    assert tvis.make_frame(batch_dir, (('rgb', 'missing'),)) is None
    assert jvis.make_frame(batch_dir, (('rgb', 'missing'),)) is None


def captured_frames(monkeypatch, vis_module):
    """Patches the module's make_video to record its frames and path."""
    calls = []

    def fake(frames, outpath, fps=12):
        calls.append(([np.asarray(f) for f in frames], outpath, fps))
        return outpath
    monkeypatch.setattr(vis_module, 'make_video', fake)
    return calls


def assert_same_frames(got, want):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = tvis._to_rgb(g), jvis._to_rgb(w)
        assert g.shape == w.shape, i
        assert np.abs(g.astype(int) - w).max() <= FRAME_TOL, i


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return build_scene(tmp_path_factory)


def test_joint_compile_matches_jax(scene, monkeypatch):
    """The port's test.py writes a vis_test tree (its own compile there
    gives the .apng path); both models compile that tree into the same
    frames: view synthesis with the estimated light, the last view's
    OLATs, the probe round trip."""
    ckpt, config, _, _ = make_joint(scene, 'compile', 'bf16_big_chains=False')
    out = ttest.main(['--ckpt', ckpt, '--device', 'cpu'])
    outroot = out['outroot']
    assert out['video'] == outroot + '.apng'  # no video codec here
    batch_dirs = tio.sortglob(outroot, 'batch?????????')
    assert len(batch_dirs) == 3
    assert os.path.exists(join(outroot, 'pred_light.png'))
    jmodel, tmodel = JModel(config), TModel(config, device='cpu')
    assert tmodel.probe_names == jmodel.probe_names == ['courtyard',
                                                        'sunset']
    for got, want in ((tmodel.novel_probes_uint, jmodel.novel_probes_uint),
                      (tmodel.novel_olat_uint, jmodel.novel_olat_uint)):
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    tcalls = captured_frames(monkeypatch, tvis)
    jcalls = captured_frames(monkeypatch, jvis)
    got = tmodel.compile_batch_vis(batch_dirs, outroot, mode='test')
    want = jmodel.compile_batch_vis(batch_dirs, outroot, mode='test')
    assert got == want == outroot + '.mp4'
    (tframes, tpath, tfps), = tcalls
    (jframes, jpath, jfps), = jcalls
    assert (tpath, tfps) == (jpath, jfps)
    n_olat = len(tio.sortglob(batch_dirs[-1], 'pred_lvis_olat*.png'))
    assert n_olat == LIGHT_H * LIGHT_H  # the top half of the 4 x 8 lights
    assert len(tframes) == 3 + n_olat + 2 * 2 * 3
    assert_same_frames(tframes, jframes)
    # The compile written by test.py holds every frame, 83 ms each (PIL
    # merges equal neighbours into one longer frame)
    with Image.open(out['video']) as im:
        assert sum(f.info['duration'] for f in ImageSequence.Iterator(im)) \
            == len(tframes) * 83


def test_nerf_compile_matches_jax(scene, tmp_path, monkeypatch):
    """NeRF: the views' fine renders in id order, the one with a single
    nearest real capture beside it (resized to the render's height)."""
    data_root = str(tmp_path / 'data')
    config = _experiment(str(tmp_path / 'nerf' / 'run'), 'nerf.ini',
                         'data_root=%s,imh=%d,mlp_width=16' % (data_root, IMH))
    outroot = str(tmp_path / 'vis_test' / 'ckpt-2')
    rng = np.random.RandomState(6)
    for i, id_ in enumerate(('test_002', 'test_000', 'test_001')):
        batch_dir = join(outroot, 'batch%09d' % i)
        tio.write_img(rng.rand(IMH, IMH, 3), join(batch_dir, 'fine_rgb.png'))
        tio.write_json({'id': id_}, join(batch_dir, 'metadata.json'))
    tio.write_img(rng.rand(12, 9, 3),
                  join(data_root, 'test_phys_nn', 'test_000_nn_000.png'))
    batch_dirs = tio.sortglob(outroot, 'batch?????????')
    jmodel, tmodel = JNeRFModel(config), TNeRFModel(config, device='cpu')
    tcalls = captured_frames(monkeypatch, tvis)
    jcalls = captured_frames(monkeypatch, jvis)
    assert tmodel.compile_batch_vis(batch_dirs, outroot, mode='test') == \
        jmodel.compile_batch_vis(batch_dirs, outroot, mode='test') == \
        outroot + '.mp4'
    (tframes, tpath, _), = tcalls
    (jframes, jpath, _), = jcalls
    assert tpath == jpath and len(tframes) == 3
    assert tframes[0].shape[1] > IMH  # test_000 beside its capture
    assert_same_frames(tframes, jframes)


def test_compile_without_pil_writes_the_frames(tmp_path):
    """Where PIL is missing (as imageio), the video falls back to the
    port's own APNG writer; PIL reads its frames back."""
    frames = [(np.random.RandomState(i).rand(6, 10, 3) * 255).astype(
        np.uint8) for i in range(3)]
    frames[2] = frames[1]
    np.save(str(tmp_path / 'frames.npy'), np.stack(frames))
    code = ("import sys\n"
            "for m in ('imageio', 'PIL'):\n"
            "    sys.modules[m] = None\n"
            "import numpy as np\n"
            "from nerfactor_tpu_torch.utils import vis\n"
            "print(vis.make_video(list(np.load(sys.argv[1])), sys.argv[2],"
            " fps=4))\n")
    proc = subprocess.run(
        [sys.executable, '-c', code, str(tmp_path / 'frames.npy'),
         str(tmp_path / 'v.mp4')], cwd=REPO, capture_output=True,
        text=True, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    path = proc.stdout.strip().splitlines()[-1]
    assert path == str(tmp_path / 'v.apng')
    with Image.open(path) as im:
        got = [(np.asarray(f.convert('RGB')), f.info['duration'])
               for f in ImageSequence.Iterator(im)]
    assert len(got) == 3
    for (g, dur), want in zip(got, frames):
        assert dur == 250
        np.testing.assert_array_equal(g, want[:6, :10])
