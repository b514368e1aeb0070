"""PyTorch port vs the JAX package, op by op (CPU): safe math and its
gradients, positional encoding, local frames and Rusinkiewicz
coordinates, image ops and resize, lights, chunking, the PNG codec and
the checkpoint tree order. Inputs come from seeded NumPy and go through
both packages. Tolerance 1e-6 for f32 values unless stated."""

import json
import struct
import zlib

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.ops import chunk as jchunk
from nerfactor_tpu.ops import encoding as jenc
from nerfactor_tpu.ops import geom as jgeom
from nerfactor_tpu.ops import img as jimg
from nerfactor_tpu.ops import light as jlight
from nerfactor_tpu.ops import math as jmath
from nerfactor_tpu.utils import io as jio
from nerfactor_tpu_torch.ops import chunk as tchunk
from nerfactor_tpu_torch.ops import encoding as tenc
from nerfactor_tpu_torch.ops import geom as tgeom
from nerfactor_tpu_torch.ops import img as timg
from nerfactor_tpu_torch.ops import light as tlight
from nerfactor_tpu_torch.ops import math as tmath
from nerfactor_tpu_torch.utils import ckpt as tckpt
from nerfactor_tpu_torch.utils import io as tio
from tests.test_torch_chain import rusink_inputs

F32 = dict(rtol=1e-6, atol=1e-6)


def t(x):
    return torch.as_tensor(np.asarray(x, np.float32))


def close(got, want, **tol):
    got = got.detach().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               **(tol or F32))


# ------ safe math ------

def _grads_jax(fn, *args, w):
    return jax.grad(lambda *a: jnp.sum(w * fn(*a)),
                    argnums=tuple(range(len(args))))(
        *[jnp.asarray(a) for a in args])


def _grads_torch(fn, *args, w):
    ts = [t(a).requires_grad_() for a in args]
    (fn(*ts) * t(w)).sum().backward()
    return [x.grad for x in ts]


def test_safe_atan2_values_and_grads_at_kink():
    rng = np.random.RandomState(0)
    a = np.concatenate([[0.0, 0.0, 1e-8, -0.0, 1.0],
                        rng.randn(20)]).astype(np.float32)
    b = np.concatenate([[0.0, -1.0, 0.0, -2.0, 0.0],
                        rng.randn(20)]).astype(np.float32)
    w = rng.randn(a.size).astype(np.float32)
    close(tmath.safe_atan2(t(a), t(b)), jmath.safe_atan2(a, b))
    for g_t, g_j in zip(_grads_torch(tmath.safe_atan2, a, b, w=w),
                        _grads_jax(jmath.safe_atan2, a, b, w=w)):
        assert torch.isfinite(g_t).all()
        close(g_t, g_j, rtol=1e-5, atol=1e-6)


def test_safe_acos_values_and_grads_at_kinks():
    x = np.asarray([-1.5, -1.0, -0.999999, -0.5, 0.0, 0.3, 0.999999, 1.0,
                    1.2], np.float32)
    w = np.linspace(0.5, 1.5, x.size).astype(np.float32)
    close(tmath.safe_acos(t(x)), jmath.safe_acos(x))
    (g_t,) = _grads_torch(tmath.safe_acos, x, w=w)
    (g_j,) = _grads_jax(jmath.safe_acos, x, w=w)
    assert torch.isfinite(g_t).all()
    # Gradients reach ~1e3 at +-1: compare relatively
    close(g_t, g_j, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('dim', [None, 0, 1])
def test_safe_l2_normalize(dim):
    x = np.random.RandomState(1).randn(5, 3).astype(np.float32)
    x[2] = 0.0  # the eps floor
    close(tmath.safe_l2_normalize(t(x), dim=dim),
          jmath.safe_l2_normalize(jnp.asarray(x), axis=dim))


def test_divide_no_nan():
    num = np.asarray([1.0, -2.0, 0.0, 3.0], np.float32)
    den = np.asarray([2.0, 0.0, 0.0, -4.0], np.float32)
    close(tmath.divide_no_nan(t(num), t(den)),
          jmath.divide_no_nan(jnp.asarray(num), jnp.asarray(den)))


# ------ encoding, geometry ------

@pytest.mark.parametrize('n_freqs', [0, 2, 10])
def test_posenc_row_order(n_freqs):
    x = np.random.RandomState(2).uniform(-2, 2, (7, 3)).astype(np.float32)
    got = tenc.posenc(t(x), n_freqs)
    assert got.shape[1] == tenc.embed_dims(3, n_freqs) \
        == jenc.embed_dims(3, n_freqs)
    close(got, jenc.posenc(jnp.asarray(x), n_freqs), rtol=1e-6, atol=2e-6)


def test_gen_world2local():
    n = np.random.RandomState(3).randn(20, 3).astype(np.float32)
    n[0], n[1] = (0, 0, 1), (0, 0, -2)  # near the fixed up axis
    close(tgeom.gen_world2local(t(n)), jgeom.gen_world2local(jnp.asarray(n)),
          rtol=1e-5, atol=1e-6)


def test_dir2rusink_values():
    a, b = rusink_inputs()
    got = tgeom.dir2rusink(t(a), t(b)).numpy()
    want = np.asarray(jgeom.dir2rusink(jnp.asarray(a), jnp.asarray(b)))
    # phi_d and theta_h: f32 rounding of different acos/atan2 kernels
    close(got[:, :2], want[:, :2], rtol=1e-5, atol=1e-5)
    # theta_d = acos(~1) at a == b: acos' slope is unbounded at 1, so an
    # ulp of its argument moves it by up to ~sqrt(2 * 6e-8) = 3.5e-4
    close(got[:-3, 2], want[:-3, 2], rtol=1e-5, atol=1e-5)
    close(got[-3:, 2], want[-3:, 2], rtol=0, atol=5e-4)
    assert (got[:, 0] >= 0).all() and (got[:, 0] < np.pi).all()


def test_dir2rusink_grads_finite_and_match():
    a, b = rusink_inputs()
    w = np.random.RandomState(5).randn(a.shape[0], 3).astype(np.float32)
    g_t = _grads_torch(tgeom.dir2rusink, a, b, w=w)
    g_j = _grads_jax(jgeom.dir2rusink, a, b, w=w)
    for gt_, gj in zip(g_t, g_j):
        assert torch.isfinite(gt_).all()
        # Rows away from a == b: the safe-gradient rules agree closely
        close(gt_[:-3], np.asarray(gj)[:-3], rtol=1e-3, atol=1e-4)


# ------ images ------

def test_linear2srgb_tensor_and_numpy():
    x = np.asarray([-0.1, 0.0, 1e-13, 0.001, 0.0031308, 0.2, 0.9, 1.0,
                    1.5], np.float32)
    close(timg.linear2srgb(t(x)), jimg.linear2srgb(jnp.asarray(x)),
          rtol=1e-6, atol=1e-6)
    close(timg.linear2srgb(x), jimg.linear2srgb(x))
    xt = t(x).requires_grad_()
    timg.linear2srgb(xt).sum().backward()
    assert torch.isfinite(xt.grad).all()  # the 1e-12 pow clamp


def test_alpha_blend():
    rng = np.random.RandomState(6)
    img, bg = rng.rand(4, 5, 3), rng.rand(4, 5, 3)
    alpha = rng.rand(4, 5)
    close(timg.alpha_blend(img, alpha, bg), jimg.alpha_blend(img, alpha, bg))
    close(timg.alpha_blend(img, alpha), jimg.alpha_blend(img, alpha))
    close(timg.alpha_blend(t(img), t(alpha), t(bg)),
          jimg.alpha_blend(img, alpha, bg))


@pytest.mark.parametrize('shape,new_h', [
    ((32, 64, 3), 16), ((64, 64, 3), 48), ((16, 16, 3), 32),
    ((16, 32), 8), ((8, 8, 32), 4), ((16, 32, 3), 256)])
def test_resize_matches_jax(shape, new_h):
    img = np.random.RandomState(7).rand(*shape).astype(np.float32)
    got = timg.resize(img, new_h=new_h)
    want = jimg.resize(img, new_h=new_h)
    assert got.shape == want.shape and got.dtype == want.dtype
    close(got, want, rtol=0, atol=1e-6)


def test_normalize_uint():
    arr = np.asarray([[0, 128, 255]], np.uint8)
    close(timg.normalize_uint(arr), jimg.normalize_uint(arr))


# ------ lights ------

def test_light_sphere_and_olats_match_jax():
    for h in (4, 16):
        for got, want in zip(tlight.gen_light_xyz(h, 2 * h),
                             jlight.gen_light_xyz(h, 2 * h)):
            np.testing.assert_array_equal(got, want)
    got = tlight.make_olat_envmaps(4, 8, olat_inten=200.0, ambient_inten=0.5)
    want = jlight.make_olat_envmaps(4, 8, olat_inten=200.0, ambient_inten=0.5)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize('h', [None, 4, 32, 256])
def test_vis_light(h):
    probe = np.random.RandomState(8).rand(16, 32, 3).astype(np.float32) * 5
    got = tlight.vis_light(probe, h=h)
    want = jlight.vis_light(probe, h=h)
    assert got.dtype == np.uint8 and got.shape == want.shape
    # uint8 truncation of values equal to ~1e-7
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize('ext', ['npy', 'hdr'])
def test_load_light(ext, tmp_path):
    from nerfactor_tpu.utils.hdr import write_hdr
    path = str(tmp_path / ('probe.' + ext))
    probe = np.random.RandomState(9).rand(32, 64, 3).astype(np.float32) * 3
    if ext == 'npy':
        np.save(path, probe)
    else:
        write_hdr(path, probe)
    close(tlight.load_light(path, envmap_inten=2.0, envmap_h=16),
          jlight.load_light(path, envmap_inten=2.0, envmap_h=16),
          rtol=1e-6, atol=1e-5)
    with pytest.raises(ValueError):
        tlight.load_light(str(tmp_path / 'probe.png'))


# ------ chunking ------

@pytest.mark.parametrize('n,chunk', [(10, 16), (10, 4), (12, 4)])
def test_chunked_apply_tree(n, chunk):
    rng = np.random.RandomState(10)
    tree = {'a': rng.randn(n, 3).astype(np.float32),
            'b': rng.randn(n, 2, 2).astype(np.float32)}

    def fn_j(tr):
        return {'s': jnp.sum(tr['a'], 1), 'p': tr['b'] * 2 + tr['a'][:, :1, None]}

    def fn_t(tr):
        return {'s': torch.sum(tr['a'], 1),
                'p': tr['b'] * 2 + tr['a'][:, :1, None]}

    got = tchunk.chunked_apply_tree(fn_t, {k: t(v) for k, v in tree.items()},
                                    chunk)
    want = jchunk.chunked_apply_tree(fn_j, tree, chunk)
    for k in want:
        close(got[k], want[k])


# ------ PNG codec ------

def _filter_row(ftype, row, prev, bpp):
    """PNG filtering of one scanline (test-side encoder)."""
    r, p = row.astype(np.int64), prev.astype(np.int64)
    left = np.concatenate([np.zeros(bpp, np.int64), r[:-bpp]])
    up_left = np.concatenate([np.zeros(bpp, np.int64), p[:-bpp]])
    if ftype == 0:
        pred = np.zeros_like(r)
    elif ftype == 1:
        pred = left
    elif ftype == 2:
        pred = p
    elif ftype == 3:
        pred = (left + p) // 2
    else:
        pa = np.abs(p - up_left)
        pb = np.abs(left - up_left)
        pc = np.abs(left + p - 2 * up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, p, up_left))
    return ((r - pred) % 256).astype(np.uint8)


def _encode_png(arr, path, color_type):
    """Writes ``arr`` (uint8, H x W x C) cycling through all five filter
    types over the rows."""
    h, w, ch = arr.shape
    rows = arr.reshape(h, w * ch)
    raw, prev = [], np.zeros(w * ch, np.uint8)
    for y in range(h):
        ftype = y % 5
        raw.append(bytes([ftype]) + _filter_row(ftype, rows[y], prev,
                                                ch).tobytes())
        prev = rows[y]

    def chunk(ct, body):
        return (struct.pack('>I', len(body)) + ct + body
                + struct.pack('>I', zlib.crc32(ct + body) & 0xffffffff))

    with open(path, 'wb') as f:
        f.write(b'\x89PNG\r\n\x1a\n'
                + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8,
                                             color_type, 0, 0, 0))
                + chunk(b'IDAT', zlib.compress(b''.join(raw)))
                + chunk(b'IEND', b''))


@pytest.mark.parametrize('ch,color_type', [(1, 0), (2, 4), (3, 2), (4, 6)])
def test_png_reads_all_filter_types(ch, color_type, tmp_path):
    arr = np.random.RandomState(11).randint(0, 256, (13, 11, ch)) \
        .astype(np.uint8)
    # Smooth ramps too, where Sub/Up/Average/Paeth predict well
    arr[:6] = (np.arange(11)[None, :, None] * 20 + np.arange(ch)) % 256
    path = str(tmp_path / 'f.png')
    _encode_png(arr, path, color_type)
    want = np.asarray(imageio.imread(path))  # the encoder is valid PNG
    got = tio.read_png(path)
    np.testing.assert_array_equal(want.reshape(arr.shape), arr)
    np.testing.assert_array_equal(got, arr[:, :, 0] if ch == 1 else arr)


SHAPES = [(9, 7), (9, 7, 2), (9, 7, 3), (9, 7, 4)]


@pytest.mark.parametrize('shape,dtype', [(s, np.uint8) for s in SHAPES]
                         + [((9, 7), np.uint16)])
def test_png_round_trip_against_imageio(shape, dtype, tmp_path):
    rng = np.random.RandomState(12)
    arr = rng.randint(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    mine, theirs = str(tmp_path / 'mine.png'), str(tmp_path / 'theirs.png')
    tio.write_png(arr, mine)
    np.testing.assert_array_equal(np.asarray(imageio.imread(mine)), arr)
    imageio.imwrite(theirs, arr)  # PIL's adaptive filters
    np.testing.assert_array_equal(tio.read_png(theirs), arr)


@pytest.mark.parametrize('shape', SHAPES[1:])
def test_png_round_trip_16bit_color(shape, tmp_path):
    """PIL (imageio's PNG codec) has no 16-bit color modes, so 16-bit
    gray+alpha/RGB/RGBA round-trip through the port's codec alone."""
    arr = np.random.RandomState(12).randint(0, 65536, shape).astype(np.uint16)
    tio.write_png(arr, str(tmp_path / 'a.png'))
    np.testing.assert_array_equal(tio.read_png(str(tmp_path / 'a.png')), arr)


@pytest.mark.parametrize('shape', [(6, 5), (6, 5, 3), (6, 5, 4)])
def test_write_and_load_img_match_jax_io(shape, tmp_path):
    img = np.random.RandomState(13).rand(*shape).astype(np.float32) * 1.2
    written = tio.write_img(img, str(tmp_path / 'a' / 'mine.png'))
    np.testing.assert_array_equal(
        written, jio.write_img(img, str(tmp_path / 'b' / 'jax.png')))
    for force_rgba in (False, True):
        np.testing.assert_array_equal(
            tio.load_img(str(tmp_path / 'b' / 'jax.png'),
                         force_rgba=force_rgba),
            jio.load_img(str(tmp_path / 'a' / 'mine.png'),
                         force_rgba=force_rgba))


def test_json_and_glob_helpers(tmp_path):
    tio.write_json({'b': 1, 'a': [2]}, str(tmp_path / 'x' / 'm.json'))
    with open(str(tmp_path / 'x' / 'm.json')) as f:
        assert json.load(f) == jio.read_json(str(tmp_path / 'x' / 'm.json'))
    for name in ('b.npy', 'a.npy', 'c.hdr'):
        open(str(tmp_path / name), 'w').close()
    assert tio.sortglob(str(tmp_path), ext=('npy', 'hdr')) \
        == jio.sortglob(str(tmp_path), ext=('npy', 'hdr'))
    assert tio.sortglob(str(tmp_path), '*.npy') \
        == jio.sortglob(str(tmp_path), '*.npy')


# ------ checkpoint tree order ------

def test_tree_leaves_follow_jax_flatten_order():
    rng = np.random.RandomState(14)
    tree = {'z': [{'w': rng.rand(2, 3), 'b': rng.rand(3)}],
            'a': rng.rand(4), 'm': [{'w': rng.rand(1, 1), 'b': rng.rand(1)},
                                    {'w': rng.rand(2, 2), 'b': rng.rand(2)}]}
    want = jax.tree_util.tree_leaves(tree)
    got = tckpt.tree_leaves(tckpt.params_from_jax(tree))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.float32(w))
    back = tckpt.params_to_jax(tckpt.tree_unflatten(
        tckpt.params_from_jax(tree), got))
    for g, w in zip(jax.tree_util.tree_leaves(back), want):
        np.testing.assert_array_equal(g, np.float32(w))
    assert jax.tree_util.tree_structure(back) \
        == jax.tree_util.tree_structure(tree)


@pytest.mark.parametrize('ext', ['hdr', 'exr'])
def test_probe_readers_match_jax(tmp_path, ext):
    """The port's own .hdr/.exr readers decode what the JAX package's
    writers write exactly as the JAX package's readers do."""
    from nerfactor_tpu.utils import exr as jexr, hdr as jhdr
    from nerfactor_tpu_torch.utils import exr as texr, hdr as thdr
    rgb = 4 * np.random.RandomState(3).rand(8, 16, 3).astype(np.float32)
    path = str(tmp_path / ('probe.' + ext))
    if ext == 'hdr':
        jhdr.write_hdr(path, rgb)
        got, want = thdr.read_hdr(path), jhdr.read_hdr(path)
    else:
        jexr.write_exr(path, rgb)
        got, want = texr.read_exr(path), jexr.read_exr(path)
    np.testing.assert_array_equal(got, want)
