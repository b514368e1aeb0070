"""The port's image-space losses and the perceptual network vs the JAX
package (CPU).

Inputs come from numpy seeds:

  * ``ssim_index``, ``ssim`` (with and without alpha weights) and
    ``uvl2``: values and gradients against JAX;
  * LPIPS and E-LPIPS on the JAX package's ``init_random_params`` weights
    carried across by ``utils/ckpt.params_from_jax`` (HWIO -> OIHW, and
    back), E-LPIPS with the JAX draws replayed;
  * the loss registry: 'lpips' and 'elpips' raise without weights and
    work with them; both ``load_torch_weights`` layouts; the metric
    wrapper;
  * the two deviations from the JAX E-LPIPS (ADVICE.md), shown on both
    packages: its square-image crop offsets are equal, the port's drawn
    apart; its loss falls back to a fixed key, the port's raises.

Tolerances: values rtol 1e-5 (SSIM, chroma) and 1e-4 (the AlexNet taps:
f32 convolutions summed in another order); gradients by relative norm,
1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.models import losses as jlosses
from nerfactor_tpu.models import perceptual as jperceptual
from nerfactor_tpu.utils import metrics as jmetrics
from nerfactor_tpu_torch.models import losses as tlosses
from nerfactor_tpu_torch.models import perceptual as tperceptual
from nerfactor_tpu_torch.utils import ckpt as tckpt, metrics as tmetrics

IMG_SHAPE = (2, 48, 48, 3)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def images(seed, shape=IMG_SHAPE):
    rng = np.random.RandomState(seed)
    return rng.rand(*shape).astype(np.float32), \
        rng.rand(*shape).astype(np.float32), \
        (rng.rand(*shape[:-1], 1) > 0.3).astype(np.float32)


def value_and_grad_both(jfn, tfn, gt, pred, **kwargs):
    """Each package's value of fn(gt, pred) and its gradient by pred."""
    want, want_g = jax.value_and_grad(
        lambda p: jnp.sum(jfn(jnp.asarray(gt), p, **kwargs)))(
            jnp.asarray(pred))
    tkwargs = {k: torch.from_numpy(np.asarray(v)) for k, v in kwargs.items()}
    p = torch.from_numpy(pred).requires_grad_()
    got = torch.sum(tfn(torch.from_numpy(gt), p, **tkwargs))
    got.backward()
    return got.item(), p.grad.numpy(), float(want), np.asarray(want_g)


@pytest.mark.parametrize('shape', [(2, 24, 20, 3), (1, 11, 16, 1)])
def test_ssim_index_matches_jax(shape):
    gt, pred, _ = images(0, shape)
    got = tlosses.ssim_index(torch.from_numpy(gt), torch.from_numpy(pred))
    want = jlosses.ssim_index(jnp.asarray(gt), jnp.asarray(pred))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    same = tlosses.ssim_index(torch.from_numpy(gt), torch.from_numpy(gt))
    np.testing.assert_allclose(same.numpy(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError, match='at least'):
        tlosses.ssim_index(torch.zeros(1, 10, 16, 3), torch.zeros(1, 10, 16, 3))


@pytest.mark.parametrize('name', ['ssim', 'uvl2'])
@pytest.mark.parametrize('weighted', [False, True])
@pytest.mark.parametrize('keep_batch', [False, True])
def test_image_losses_and_grads_match_jax(name, weighted, keep_batch):
    gt, pred, alpha = images(1, (2, 24, 20, 3))
    kwargs = {'keep_batch': keep_batch}
    if weighted:
        kwargs['weights'] = alpha
    jfn, tfn = jlosses.get_loss_fn(name), tlosses.get_loss_fn(name)
    assert tfn is getattr(tlosses, name)
    want = np.asarray(jfn(jnp.asarray(gt), jnp.asarray(pred), **kwargs))
    got = tfn(torch.from_numpy(gt), torch.from_numpy(pred), **{
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
        for k, v in kwargs.items()})
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    jkw = {'weights': alpha} if weighted else {}
    _, g, _, w = value_and_grad_both(jfn, tfn, gt, pred, **jkw)
    assert rel_norm(g, w) <= 1e-4


def test_rgb_to_yuv_matches_jax():
    rgb = np.random.RandomState(2).rand(5, 7, 3).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.rgb_to_yuv(torch.from_numpy(rgb)).numpy(),
        np.asarray(jlosses.rgb_to_yuv(jnp.asarray(rgb))), rtol=1e-6,
        atol=1e-7)


@pytest.fixture(scope='module')
def lpips_params():
    """The JAX package's random LPIPS weights and the port's copy."""
    jp = jperceptual.init_random_params(jax.random.PRNGKey(0))
    return jp, tckpt.params_from_jax(jp)


def test_params_bridge_round_trip(lpips_params):
    jp, tp = lpips_params
    for (jw, jb), (tw, tb) in zip(jp['convs'], tp['convs']):
        assert tuple(tw.shape) == (jw.shape[3], jw.shape[2], jw.shape[0],
                                   jw.shape[1])
        np.testing.assert_array_equal(tw.numpy(), np.transpose(
            np.asarray(jw), (3, 2, 0, 1)))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    back = tckpt.params_to_jax(tp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert [tuple(t.shape) for t in tckpt.tree_leaves(
        tperceptual.init_random_params(torch.Generator()))] == \
        [tuple(t.shape) for t in tckpt.tree_leaves(tp)]


def test_lpips_matches_jax(lpips_params):
    jp, tp = lpips_params
    im0, im1, _ = images(3)
    want = np.asarray(jperceptual.lpips(jp, jnp.asarray(im0),
                                        jnp.asarray(im1)))
    got = tperceptual.lpips(tp, torch.from_numpy(im0), torch.from_numpy(im1))
    assert got.shape == (IMG_SHAPE[0],) and (want > 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    same = tperceptual.lpips(tp, torch.from_numpy(im0), torch.from_numpy(im0))
    np.testing.assert_allclose(same.numpy(), 0.0, atol=1e-6)
    # Gradients by the second image
    _, g, _, w = value_and_grad_both(
        lambda a, b: jperceptual.lpips(jp, a, b),
        lambda a, b: tperceptual.lpips(tp, a, b), im0, im1)
    assert rel_norm(g, w) <= 1e-4
    with pytest.raises(ValueError, match='32 x 32'):
        tperceptual.lpips(tp, torch.zeros(1, 16, 48, 3),
                          torch.zeros(1, 16, 48, 3))


def jax_draws(key, h, w, n_draws=8):
    """The transformations the JAX package's ``elpips`` draws from
    ``key`` (perceptual._transform_pair's splits), as the port's draw
    dicts. Its crop offsets share one key: oy == ox when h == w."""
    ch, cw = tperceptual._crop_size(h, w)
    draws = []
    for k in jax.random.split(key, n_draws):
        k_off, k_flip, k_tr, k_perm, k_mul = jax.random.split(k, 5)
        fx, fy = jax.random.bernoulli(k_flip, shape=(2,))
        draws.append({
            'oy': int(jax.random.randint(k_off, (), 0, h - ch + 1)),
            'ox': int(jax.random.randint(k_off, (), 0, w - cw + 1)),
            'fx': bool(fx), 'fy': bool(fy),
            'tr': bool(jax.random.bernoulli(k_tr)) if ch == cw else False,
            'perm': np.asarray(jax.random.permutation(k_perm, 3)).tolist(),
            'mul': float(jax.random.uniform(k_mul, (), minval=0.2,
                                            maxval=1.0))})
    return draws


@pytest.mark.parametrize('hw', [(48, 48), (48, 40)])
def test_elpips_matches_jax_with_its_draws(lpips_params, hw):
    jp, tp = lpips_params
    im0, im1, _ = images(4, (2,) + hw + (3,))
    key = jax.random.PRNGKey(7)
    want = np.asarray(jperceptual.elpips(jp, jnp.asarray(im0),
                                         jnp.asarray(im1), key))
    draws = jax_draws(key, *hw)
    got = tperceptual.elpips(tp, torch.from_numpy(im0), torch.from_numpy(im1),
                             draws=draws)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4)
    # The draws replayed are the JAX package's: on square images its
    # crop offsets coincide (ADVICE.md), the port's are drawn apart
    if hw[0] == hw[1]:
        assert all(d['oy'] == d['ox'] for d in draws)
        mine = tperceptual.draw_transforms(torch.Generator().manual_seed(0),
                                           *hw, n_draws=32)
        assert any(d['oy'] != d['ox'] for d in mine)
        assert all(0 <= d['oy'] <= 8 and 0 <= d['ox'] <= 8 for d in mine)


def test_loss_registry_gates_perceptual_losses(lpips_params, monkeypatch,
                                               tmp_path):
    jp, tp = lpips_params
    for mod in (jperceptual, tperceptual):
        monkeypatch.setattr(mod, '_cached', None)
    monkeypatch.setenv('NERFACTOR_LPIPS_WEIGHTS', str(tmp_path / 'none.pth'))
    for name in ('lpips', 'elpips'):
        for mod in (jlosses, tlosses):
            with pytest.raises(NotImplementedError, match='LPIPS_WEIGHTS'):
                mod.get_loss_fn(name)
    with pytest.raises(NotImplementedError, match='weights'):
        tmetrics.lpips(np.zeros((32, 32, 3)), np.zeros((32, 32, 3)))
    with pytest.raises(NotImplementedError):
        tlosses.get_loss_fn('nope')
    monkeypatch.setattr(jperceptual, '_cached', jp)
    monkeypatch.setattr(tperceptual, '_cached', tp)
    im0, im1, alpha = images(5)
    for keep in (False, True):
        want = jlosses.get_loss_fn('lpips')(
            jnp.asarray(im0), jnp.asarray(im1), keep_batch=keep,
            weights=jnp.asarray(alpha))
        got = tlosses.get_loss_fn('lpips')(
            torch.from_numpy(im0), torch.from_numpy(im1), keep_batch=keep,
            weights=torch.from_numpy(alpha))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4)
    # The JAX loss without a key is its loss at PRNGKey(0), every call
    # (ADVICE.md); the port's raises without a generator or draws
    jel = jlosses.get_loss_fn('elpips')
    no_key = np.asarray(jel(jnp.asarray(im0), jnp.asarray(im1)))
    np.testing.assert_array_equal(no_key, np.asarray(jel(
        jnp.asarray(im0), jnp.asarray(im1), key=jax.random.PRNGKey(0))))
    np.testing.assert_array_equal(no_key, np.asarray(jel(
        jnp.asarray(im0), jnp.asarray(im1))))
    tel = tlosses.get_loss_fn('elpips')
    with pytest.raises(ValueError, match='generator or draws'):
        tel(torch.from_numpy(im0), torch.from_numpy(im1))
    got = tel(torch.from_numpy(im0), torch.from_numpy(im1),
              draws=jax_draws(jax.random.PRNGKey(0), 48, 48))
    np.testing.assert_allclose(got.numpy(), no_key, rtol=1e-4)
    drawn = [tel(torch.from_numpy(im0), torch.from_numpy(im1),
                 generator=torch.Generator().manual_seed(s)).item()
             for s in (0, 0, 1)]
    assert drawn[0] == drawn[1] != drawn[2]


def _lpips_state_dicts(tp):
    """The port's parameters as the two standard checkpoint layouts."""
    slice_of = ((1, 0), (2, 3), (3, 6), (4, 8), (5, 10))
    tv_idx = (0, 3, 6, 8, 10)
    lins = {'lin%d.model.1.weight' % i: lin.reshape(1, -1, 1, 1).clone()
            for i, lin in enumerate(tp['lins'])}
    full, trunk = dict(lins), {}
    for i, (w, b) in enumerate(tp['convs']):
        sk, sj = slice_of[i]
        full['net.slice%d.%d.weight' % (sk, sj)] = w.clone()
        full['net.slice%d.%d.bias' % (sk, sj)] = b.clone()
        trunk['features.%d.weight' % tv_idx[i]] = w.clone()
        trunk['features.%d.bias' % tv_idx[i]] = b.clone()
    return full, trunk, lins


def test_load_torch_weights_both_layouts(lpips_params, tmp_path):
    jp, tp = lpips_params
    full, trunk, lins = _lpips_state_dicts(tp)
    paths = {}
    for name, state in (('full', full), ('trunk', trunk), ('lins', lins)):
        paths[name] = str(tmp_path / (name + '.pth'))
        torch.save(state, paths[name])
    for args in ((paths['full'],), (paths['trunk'], paths['lins'])):
        got = tperceptual.load_torch_weights(*args)
        want = jperceptual.load_torch_weights(*args)
        for a, b in zip(tckpt.tree_leaves(got), tckpt.tree_leaves(tp)):
            assert torch.equal(a, b)
        for a, b in zip(tckpt.tree_leaves(tckpt.params_to_jax(got)),
                        jax.tree_util.tree_leaves(want)):
            np.testing.assert_array_equal(a, np.asarray(b))
    with pytest.raises(KeyError, match='none of'):
        tperceptual.load_torch_weights(paths['lins'])


def test_lpips_metric_matches_jax(lpips_params):
    jp, tp = lpips_params
    rng = np.random.RandomState(6)
    im1 = (rng.rand(40, 36, 3) * 255).astype(np.uint8)
    im2 = (rng.rand(40, 36, 3) * 255).astype(np.uint8)
    np.testing.assert_allclose(
        tmetrics.lpips(im1, im2, params=tp),
        jmetrics.lpips(im1, im2, params=jp), rtol=1e-4)
    gray1, gray2 = im1[:, :, 0], im2[:, :, 0]
    np.testing.assert_allclose(
        tmetrics.lpips(gray1, gray2, params=tp),
        jmetrics.lpips(gray1, gray2, params=jp), rtol=1e-4)
    np.testing.assert_allclose(
        tmetrics.lpips(im1 / 255.0, im2 / 255.0, drange='float', params=tp),
        tmetrics.lpips(im1, im2, params=tp), rtol=1e-5)
