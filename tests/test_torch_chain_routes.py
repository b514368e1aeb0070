"""The chain's other routes and the dot-chain probe vs the JAX package's
(CPU), with their card tests.

* The stash route (K1r; ``_fused_chain(transposed=False)``): the port's
  plain version (:func:`fused_mlp.chain_reference_stash`, its stash
  :func:`fused_mlp.trig_stash`) against the JAX package's row-major trig
  kernels ``_pallas_forward_trig`` / ``_pallas_backward_trig`` in
  interpret mode.
* Plans with a skip after the last layer (K1w): f32 against the JAX
  package's ``apply_chain`` in interpret mode (its ``_pallas_forward`` /
  ``_pallas_backward``); bf16 against its ``chain_reference(bf16)``,
  since that TPU route ignores a per-call bf16 compute dtype (the
  deviation the port documents: :func:`test_last_skip_bf16_deviation`).
* Kernel P's plain version against the same chain written in JAX, and
  both probe tools on the CPU.

Tolerances are test_torch_chain's: outputs f32 1e-5, bf16 1e-2;
gradients f32 1e-4, bf16 rtol 0.1 atol 0.05 (the plain version rounds
every cotangent at each cast, the kernels only d_pre). Tests of the CUDA
kernels carry the ``cuda`` marker and skip without a card.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu_torch.ops import dot_probe as dp
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_nerf as fn
from nerfactor_tpu_torch.tools import chain_probe, dot_probe
from tests.test_torch_chain import (
    DTYPES, DW_TOL, GRAD_TOL, PLANS, TOL, both, chain_inputs, cuda,  # noqa: F401
    rel_norm)


def last_skip_args(name):
    """PLANS[name] with its skip moved after the last layer."""
    parts, widths, acts, _ = PLANS[name]
    return parts, widths, acts, (len(widths) - 1,)


LAST_SKIP = {name: last_skip_args(name) for name in PLANS}


def case(plan_args, n, seed):
    """Both packages' plan and weights, inputs x (n, raw) and an output
    cotangent dy (n, out_dim), NumPy from ``seed``."""
    jplan, jp, tplan, tp = both(plan_args, seed=seed)
    x = chain_inputs(jplan, n=n, seed=seed + 1)
    dy = np.random.RandomState(seed + 2).uniform(
        -1, 1, (n, pm.out_dim(jplan))).astype(np.float32)
    return jplan, jp, tplan, tp, x, dy


def torch_grads(ref, tplan, tp, x, dy, td, device='cpu'):
    """(y, [dx, dW0, db0, ...]) of the port's ``ref`` under autograd, on
    NumPy ``x`` and ``dy`` moved to ``device`` (the weights' device)."""
    ins = [torch.from_numpy(x).to(device).requires_grad_()] + [
        t.clone().requires_grad_() for pair in tp for t in pair]
    y = ref(tplan, ins[0], fm._pairs(ins[1:]), compute_dtype=td)
    return y.detach(), list(torch.autograd.grad(
        y, ins, torch.from_numpy(dy).to(device)))


def jax_stash_route(jplan, jp, x, dy, jd, needs_dx=True):
    """The JAX package's row-major route in interpret mode at kernel dtype
    ``jd`` (None: true f32): (y, stash, dx or None, [dW0, db0, ...])."""
    pm.INTERPRET = True
    try:
        with pm._kernel_dtype_scope(jd):
            y, trig = pm._pallas_forward_trig(jplan, jnp.asarray(x), jp,
                                              with_stash=True)
            dx, dparams = pm._pallas_backward_trig(
                jplan, jnp.asarray(x), jp, jnp.asarray(dy), trig, needs_dx)
    finally:
        pm.INTERPRET = False
    n = x.shape[0]
    return (np.asarray(y), np.asarray(trig[:n].astype(jnp.float32)),
            None if dx is None else np.asarray(dx),
            [np.asarray(t) for pair in dparams for t in pair])


def jax_apply_grads(fn_, jplan, jp, x, dy):
    """(y, [dx, dW0, db0, ...]) of a JAX chain function under jax.grad."""
    y, vjp = jax.vjp(lambda x_, p_: fn_(jplan, x_, p_), jnp.asarray(x), jp)
    gx, gp = vjp(jnp.asarray(dy))
    return np.asarray(y), [np.asarray(g) for g in
                           [gx] + [t for pair in gp for t in pair]]


def assert_grads_close(got, want, mode, skip_dx=False):
    for i, (g, w) in enumerate(zip(got, want)):
        if i == 0 and skip_dx:
            continue
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg='cotangent %d' % i,
                                   **GRAD_TOL[mode])


# ------ the stash route (K1r) ------

def test_trig_helpers_match_jax():
    """trig_dim, trig_perm and the stash's frequencies and phases are the
    JAX package's (its A and P as (column, 2^j, phase) per stash column)."""
    assert fm.HALF_PI == float(np.float32(np.pi / 2))
    for args in PLANS.values():
        jplan, tplan = pm.make_plan(*args), fm.make_plan(*args)
        assert fm.trig_dim(tplan) == pm.trig_dim(jplan)
        assert fm.trig_perm(tplan) == list(pm.trig_perm(jplan))
        a, p = pm._trig_mats(jplan)
        cols, freqs, phases = fm._trig_mats(tplan)
        assert cols == list(a.argmax(axis=0))
        assert freqs == list(a.max(axis=0))
        np.testing.assert_array_equal(np.float32(phases), p[0])


@pytest.mark.parametrize('needs_dx', [True, False])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_stash_route_plain_matches_interpreted_pallas_kernel(name, mode,
                                                             needs_dx):
    """Output, stash and gradients of the port's plain stash route against
    the JAX row-major trig kernels; the stash also against the reference
    embedding's columns through trig_perm (the pi/2 add rounds: 1e-5)."""
    jplan, jp, tplan, tp, x, dy = case(PLANS[name], 50, seed=60)
    jd, td = DTYPES[mode]
    y_j, stash_j, dx_j, dw_j = jax_stash_route(jplan, jp, x, dy, jd,
                                               needs_dx)
    y, got = torch_grads(fm.chain_reference_stash, tplan, tp, x, dy, td)
    np.testing.assert_allclose(y.numpy(), y_j, **TOL[mode])
    xt = torch.from_numpy(x)
    stash = fm.trig_stash(tplan, xt).to(fm.kernel_dtype(td)).float()
    np.testing.assert_allclose(stash.numpy(), stash_j, rtol=0,
                               atol=1e-6 if mode == 'f32' else 2 ** -8)
    t = fm.trig_dim(tplan)
    np.testing.assert_allclose(
        fm.trig_stash(tplan, xt).numpy(),
        fm._embed(tplan, xt)[:, fm.trig_perm(tplan)[:t]].numpy(), atol=1e-5)
    assert (dx_j is None) != needs_dx
    assert_grads_close(got, [dx_j] + dw_j, mode, skip_dx=not needs_dx)


def test_fused_chain_routes_on_cpu(monkeypatch):
    """On a CPU tensor _fused_chain takes its route's plain version:
    chain_reference for K1, chain_reference_stash for the stash route
    (transposed=False, or TRANSPOSED_BOUNDARY = False); apply_chain takes
    chain_reference."""
    _, _, tplan, tp = both(PLANS['lvis'], seed=61)
    x = torch.from_numpy(chain_inputs(tplan, seed=62))
    plain = fm.chain_reference(tplan, x, tp)
    stash = fm.chain_reference_stash(tplan, x, tp)
    assert not torch.equal(plain, stash)
    assert torch.equal(fm._fused_chain(tplan, x, tp), plain)
    assert torch.equal(fm._fused_chain(tplan, x, tp, transposed=False), stash)
    monkeypatch.setattr(fm, 'TRANSPOSED_BOUNDARY', False)
    assert torch.equal(fm._fused_chain(tplan, x, tp), stash)
    assert torch.equal(fm.apply_chain(tplan, x, tp), plain)


# ------ plans with a skip after the last layer (K1w) ------

@pytest.mark.parametrize('name', sorted(PLANS))
def test_last_skip_matches_interpreted_pallas_kernel(name):
    """f32: output [head | embedding] and gradients (dy's embedding
    columns reach dx) against the JAX package's K1w route."""
    jplan, jp, tplan, tp, x, dy = case(LAST_SKIP[name], 50, seed=63)
    pm.INTERPRET = True
    try:
        y_j, want = jax_apply_grads(pm.apply_chain, jplan, jp, x, dy)
    finally:
        pm.INTERPRET = False
    for transposed in (True, False):
        y, got = torch_grads(
            lambda *a, **k: fm._fused_chain(*a, transposed=transposed, **k),
            tplan, tp, x, dy, None)
        assert y.shape == (50, fm.out_dim(tplan))
        np.testing.assert_allclose(y.numpy(), y_j, **TOL['f32'])
        assert_grads_close(got, want, 'f32')


@pytest.mark.parametrize('name', sorted(PLANS))
def test_last_skip_bf16_matches_jax_reference(name):
    """bf16: the port's last-skip chain against the JAX package's
    chain_reference(bf16), output and gradients."""
    jplan, jp, tplan, tp, x, dy = case(LAST_SKIP[name], 50, seed=64)
    y_j, want = jax_apply_grads(
        lambda *a: pm.chain_reference(*a, compute_dtype=jnp.bfloat16),
        jplan, jp, x, dy)
    y, got = torch_grads(fm._fused_chain, tplan, tp, x, dy, torch.bfloat16)
    np.testing.assert_allclose(y.numpy(), y_j, **TOL['bf16'])
    assert_grads_close(got, want, 'bf16')


@pytest.mark.parametrize('name', sorted(PLANS))
def test_last_skip_bf16_deviation(name):
    """The documented deviation: the JAX package's K1w route reads the
    global networks.MATMUL_DTYPE, so its bf16 call is bit-identical to its
    f32 call; the port's last-skip chain takes the per-call bf16 and parts
    from f32 by bf16 rounding."""
    jplan, jp, tplan, tp, x, _ = case(LAST_SKIP[name], 64, seed=65)
    pm.INTERPRET = True
    try:
        j32, j16 = (np.asarray(pm.apply_chain(jplan, jnp.asarray(x), jp,
                                              compute_dtype=jd))
                    for jd in (None, jnp.bfloat16))
    finally:
        pm.INTERPRET = False
    np.testing.assert_array_equal(j16, j32)
    xt = torch.from_numpy(x)
    t32, t16 = (fm._fused_chain(tplan, xt, tp, compute_dtype=td).numpy()
                for td in (None, torch.bfloat16))
    np.testing.assert_allclose(t32, j32, **TOL['f32'])
    assert np.abs(t16 - t32).max() > 1e-3


def test_nerf_kernel_refuses_last_skip_trunk():
    """K3 takes no trunk with a skip after its last layer, though K1 now
    takes such a chain."""
    nplan = fn.make_nerf_plan(n_freqs_xyz=4, n_freqs_view=2, width=32,
                              depth=4, skip_at=3, act='relu',
                              rgb_widths=(16, 3), rgb_acts=('relu', 'sigmoid'))
    assert fm.kernel_supports(nplan.trunk_plan)
    assert not fn.kernel_supports(nplan)
    with pytest.raises(NotImplementedError):
        fn.make_desc(nplan)
    assert fn.kernel_supports(nplan._replace(
        trunk_plan=nplan.trunk_plan._replace(skip_at=(1,))))


# ------ kernel P's plain version and the probes ------

def jax_dot_chain(x_t, ws, mode):
    """The TPU probe kernel's chain, written in JAX over (width, cols)."""
    y = jnp.asarray(x_t).astype(jnp.bfloat16)
    ws = [jnp.asarray(w, jnp.bfloat16) for w in ws]

    def dot(w, v):
        return jax.lax.dot(w, v, preferred_element_type=jnp.float32)

    if mode == 'serial':
        for w in ws:
            y = dot(w, y).astype(jnp.bfloat16)
        return np.asarray(y.astype(jnp.float32))
    if mode == 'indep':
        acc = jnp.zeros(y.shape, jnp.float32)
        for w in ws:
            acc += dot(w, y)
        return np.asarray(acc)
    y1, y2 = y, y
    for i in range(0, len(ws), 2):
        y1 = dot(ws[i], y1).astype(jnp.bfloat16)
        y2 = dot(ws[i + 1], y2).astype(jnp.bfloat16)
    return np.asarray(y1.astype(jnp.float32) + y2.astype(jnp.float32))


@pytest.mark.parametrize('mode', dp.MODES)
def test_dot_chain_reference_matches_jax(mode):
    """Width 32, 96 columns, depth 4: indep sums exact bf16 products in f32
    (1e-5); serial and pair round to bf16 after every pass, where the two
    f32 sums can round a value to neighbouring bf16 (2^-8 relative), so
    they are held by relative norm: over 6 seeds at most one value in
    3,072 parted, 6.1e-8, bound 1e-3."""
    rng = np.random.RandomState(66)
    ws = np.stack([np.linalg.qr(rng.randn(32, 32))[0] for _ in range(4)])
    x = (0.1 * rng.randn(96, 32)).astype(np.float32)
    want = jax_dot_chain(x.T, ws, mode).T
    got = dp.dot_chain(torch.from_numpy(x), torch.from_numpy(ws), mode)
    if mode == 'indep':
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    else:
        assert rel_norm(got, torch.tensor(want)) <= 1e-3
    with pytest.raises(ValueError):
        dp.dot_chain(torch.from_numpy(x), torch.from_numpy(ws[:3]), 'pair')


@pytest.mark.parametrize('impl', ['ref', 'fused', 'fused_rowmajor'])
def test_chain_probe_cli_on_cpu(impl, capsys):
    record = chain_probe.main(['--device', 'cpu', '--impl', impl, '--rows',
                               '64', '--steps', '2', '--width', '16',
                               '--needs_dx'])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == record
    assert {'impl', 'mode', 'rows', 'compute_dtype', 'matmul_dtype',
            'ms_per_step', 'checksum'} <= set(record)
    assert record['impl'] == impl and np.isfinite(record['checksum'])


@pytest.mark.parametrize('flag', ['--compute_dtype', '--matmul_dtype'])
def test_chain_probe_reports_the_precision_it_ran(flag):
    """Either JAX flag selects the port's one compute dtype; the record
    names it under both keys."""
    record = chain_probe.main(['--device', 'cpu', '--impl', 'ref', '--rows',
                               '32', '--steps', '1', '--width', '16', flag,
                               'bf16'])
    assert record['compute_dtype'] == record['matmul_dtype'] == 'bf16'


@pytest.mark.parametrize('sweep', [False, True])
def test_dot_probe_cli_on_cpu(sweep, capsys):
    argv = ['--device', 'cpu', '--cols', '512', '--width', '32', '--depths',
            '2,4', '--steps', '1', '--block', '256']
    summary = dot_probe.main(argv + (['--grid_sweep'] if sweep else []))
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines()]
    assert lines[-1]['summary'] == summary
    if sweep:
        assert [r['block'] for r in lines[:-1]] == list(dot_probe.SWEEP_BLOCKS)
        assert all({'grid', 'ms', 'ms_per_pass'} <= set(r)
                   for r in lines[:-1])
    else:
        assert set(summary) == set(dp.MODES)
        assert all(set(v) == {'ms_per_pass', 'intercept_ms'}
                   for v in summary.values())
    with pytest.raises(ValueError, match='even'):
        dot_probe.main(['--device', 'cpu', '--depths', '3,4'])


# ------ on the card ------

@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 50, 4099])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_stash_kernels_match_plain_on_card(name, mode, n, cuda):
    """K1r-fwd (with and without the stash) and K1r-bwd under autograd
    against the plain stash route; dW/db bit-identical across launches."""
    _, _, tplan, tp = both(PLANS[name], seed=67)
    x = torch.from_numpy(chain_inputs(tplan, n=n, seed=68)).to(cuda)
    dy = torch.rand(n, fm.out_dim(tplan), device=cuda) * 2 - 1
    tp = [(w.to(cuda), b.to(cuda)) for w, b in tp]
    td = DTYPES[mode][1]
    y, stash = fm.chain_kernel_stash(tplan, x, tp, td, with_stash=True)
    assert torch.equal(y, fm.chain_kernel_stash(tplan, x, tp, td)[0])
    np.testing.assert_allclose(
        stash.float().cpu().numpy(),
        fm.trig_stash(tplan, x).to(stash.dtype).float().cpu().numpy(),
        rtol=0, atol=1e-6 if mode == 'f32' else 2 ** -8)
    launches = fm.chain_kernel_stash_bwd.launches
    x_np, dy_np = x.cpu().numpy(), dy.cpu().numpy()
    got = torch_grads(lambda *a, **k: fm._fused_chain(*a, transposed=False,
                                                      **k),
                      tplan, tp, x_np, dy_np, td, device=cuda)
    assert fm.chain_kernel_stash_bwd.launches == launches + 1
    want = torch_grads(fm.chain_reference_stash, tplan, tp, x_np, dy_np, td,
                       device=cuda)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                               **TOL[mode])
    for g, w in zip(got[1], want[1]):
        assert rel_norm(g, w) <= DW_TOL[mode]
    runs = [fm.chain_kernel_stash_bwd(tplan, x, dy, stash, tp, td)[1]
            for _ in range(2)]
    assert all(torch.equal(a, b) for pa, pb in zip(*runs)
               for a, b in zip(pa, pb))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 50, 4099])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_last_skip_kernels_match_plain_on_card(name, mode, n, cuda):
    """K1w-fwd and K1w-bwd under autograd against the plain version."""
    _, _, tplan, tp = both(LAST_SKIP[name], seed=69)
    x = torch.from_numpy(chain_inputs(tplan, n=n, seed=70))
    dy = np.random.RandomState(71).uniform(
        -1, 1, (n, fm.out_dim(tplan))).astype(np.float32)
    td = DTYPES[mode][1]
    tp_c = [(w.to(cuda), b.to(cuda)) for w, b in tp]
    launches = (fm.chain_kernel_last_skip.launches,
                fm.chain_kernel_last_skip_bwd.launches)
    y, got = torch_grads(fm.apply_chain, tplan, tp_c, x.numpy(), dy, td,
                         device=cuda)
    assert (fm.chain_kernel_last_skip.launches,
            fm.chain_kernel_last_skip_bwd.launches) == (launches[0] + 1,
                                                        launches[1] + 1)
    y_p, want = torch_grads(fm.chain_reference, tplan, tp, x.numpy(), dy, td)
    np.testing.assert_allclose(y.cpu().numpy(), y_p.numpy(), **TOL[mode])
    for i, (g, w) in enumerate(zip(got, want)):
        assert rel_norm(g.cpu(), w) <= DW_TOL[mode], i


@pytest.mark.cuda
@pytest.mark.parametrize('mode', dp.MODES)
def test_dot_chain_kernel_matches_plain_on_card(mode, cuda):
    """Kernel P (wgmma) and its mma.sync control against the plain version
    at width 128: 1, 255, 1,000 and 4,099 rows (ragged ends), blocks of
    256 and 512, depth 4 and a depth past the weight ring; one launch
    counted a call, and two launches bit-identical."""
    rng = np.random.RandomState(72)
    tol = dp.TOL[mode]
    assert dp.plan(mode) == (dp.RING_MATS, dp.STAGE_MATS[mode],
                             dp.CHUNK_ROWS[mode])
    for depth in (4, dp.ring_refill_depth(mode)):
        ws = torch.as_tensor(np.stack([np.linalg.qr(rng.randn(128, 128))[0]
                                       for _ in range(depth)]),
                             dtype=torch.bfloat16, device=cuda)
        for rows in (1, 255, 1000, 4099):
            x = 0.1 * torch.randn(rows, 128, device=cuda)
            want = dp.dot_chain_reference(x, ws, mode)
            for block in (256, 512):
                launches = dp.dot_chain_kernel.launches
                got = dp.dot_chain(x, ws, mode, block=block)
                again = dp.dot_chain_kernel(x, ws, mode, block=block)
                control = dp._dot_chain_mma(x, ws, mode, block=block)
                torch.cuda.synchronize()
                case = (depth, rows, block)
                assert dp.dot_chain_kernel.launches == launches + 2, case
                assert torch.equal(got, again), case
                assert torch.isfinite(got).all(), case
                assert rel_norm(got, want) <= tol, case
                assert rel_norm(control, want) <= tol, case


@pytest.mark.cuda
@pytest.mark.parametrize('ss', [False, True], ids=['rs', 'ss'])
def test_wgmma_tile_matches_float64_on_card(ss, cuda):
    """The wgmma building blocks (csrc/wgmma.cuh) on the card: A from
    registers or shared memory, B through its 128-byte-swizzled
    descriptor, within 1e-4 + 1e-4 rel of float64 (the layout the CPU
    emulation decodes is the card's)."""
    rng = np.random.RandomState(73 + ss)
    a, w = (torch.as_tensor(rng.uniform(-1, 1, shape), dtype=torch.bfloat16)
            for shape in ((64, 128), (128, 128)))
    got = dp.wgmma_tile(a.to(cuda), w.to(cuda), ss=ss).double().cpu()
    want = dp.wgmma_tile_reference(a, w)
    assert ((got - want).abs() <= 1e-4 + 1e-4 * want.abs()).all()
