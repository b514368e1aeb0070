"""K1's f32 forward and f32 dx-only backward on the tensor cores, in split
TF32 ("3xTF32": each f32 operand split into TF32 hi and lo, each product
lo hi + hi lo + hi hi on mma.sync m16n8k8), against the JAX Pallas kernels
in interpret mode and the plain versions, on the CPU through the g++
emulation of the CUDA sources (``test_torch_emu``), whose mma.sync.m16n8k8
and cvt.rna.tf32.f32 have the instructions' lane mapping and rounding.

The plans: NeRF's sigma chain (posenc of xyz at 10 octaves, a 1-wide
linear head) narrowed to 4 x 64 with the embedding concatenated after
layer 2, at 130 rows (two tiles and a ragged edge), and at its full
nerf.ini width, 8 x 256 with the skip after layer 4, whose skip consumer
(256 + 63 inputs) takes the dx tile's two-product path. The limits are
those of ``test_torch_geometry``'s test of the fused sigma and its point
gradient against the Pallas kernel: 2e-4 elementwise for the forward,
1e-4 relative norm for dx. Plain TF32 (hi hi alone), the control, must
break the dx limit. Then distillation's depth/normal block on the
emulated kernels against the JAX package's block.

  JAX_PLATFORMS=cpu python -m tests.test_torch_f32_tc

prints the readings (the sound kernels' and the control's).
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu_torch.ops import fused_mlp as fm
from tests.test_torch_chain import both, chain_inputs

CPU = torch.device('cpu')
# NeRF's sigma chain (models/nerf.py sigma_plan, use_views: the sigma_out
# head), narrowed; and at nerf.ini's width
SIGMA_NARROW = ([(3, 10)], (64,) * 4 + (1,), ('relu',) * 4 + (None,), (2,))
SIGMA_FULL = ([(3, 10)], (256,) * 8 + (1,), ('relu',) * 8 + (None,), (4,))
# test_torch_geometry.test_eval_sigma_and_its_gradient_match_pallas_kernel
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
DX_TOL = 1e-4


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    from tests.test_torch_emu import emulated_library
    with emulated_library(str(tmp_path_factory.mktemp('emu'))):
        yield


def calls_of(launch):
    """``launch()``'s result and the library entries it called."""
    from tests.test_torch_emu import CALLS
    del CALLS[:]
    out = launch()
    return out, list(CALLS)


def case(plan_args, n, seed):
    """The torch plan and params, x (n, 3) and a head cotangent dy (n, 1)
    whose rows are 0 or 1 (as distillation's ReLU'd sigma gives), from
    numpy draws; with the JAX plan and params."""
    jplan, jp, plan, p = both(plan_args, seed=seed)
    x = chain_inputs(plan, n=n, seed=seed + 1)
    dy = (np.random.RandomState(seed + 2).uniform(size=(n, 1)) > 0.3) \
        .astype(np.float32)
    return jplan, jp, plan, p, x, dy


def pallas_fwd_dx(jplan, jp, x, dy):
    """The Pallas K1-fwd's output and K1-bwd's dx with needs_dw=False (the
    JAX package's frozen-weights call), in interpret mode, f32."""
    pm.INTERPRET = True
    try:
        y, vjp = jax.vjp(lambda x_: pm.apply_chain(jplan, x_, jp,
                                                  needs_dw=False),
                         jnp.asarray(x))
        gx, = vjp(jnp.asarray(dy))
    finally:
        pm.INTERPRET = False
    return np.asarray(y), np.asarray(gx)


def kernel_fwd_dx(plan, p, x, dy, terms=3):
    """The emulated f32 tensor-core K1-fwd's output and dx-only K1-bwd's
    dx with ``terms`` TF32 products."""
    x, dy = torch.from_numpy(x), torch.from_numpy(dy)
    return (fm.chain_kernel_f32_tc(plan, x, p, terms).numpy(),
            fm.chain_kernel_bwd_dx_f32_tc(plan, x, dy, p, terms).numpy())


# ------ the product itself ------

def tf32_rna(a):
    """cvt.rna.tf32.f32 in numpy: the f32 bits rounded to nearest, ties
    away from zero, the 13 low bits dropped (finite values)."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def test_tf32_rna_rounds_ties_away_from_zero():
    """The numpy reference of the rounding: 1 + 2^-11 (a tie) goes up to
    1 + 2^-10, -(1 + 2^-11) down to -(1 + 2^-10); 1 + 2^-11 - 2^-23 to 1."""
    one = np.float32(1)
    tie = np.float32(1 + 2.0 ** -11)
    assert tf32_rna(tie) == np.float32(1 + 2.0 ** -10)
    assert tf32_rna(-tie) == -np.float32(1 + 2.0 ** -10)
    assert tf32_rna(np.nextafter(tie, one)) == one


# (m, n, k): ragged rows, columns past one 256-wide pass, K off the 16 step
MATMUL_SHAPES = [(1, 8, 8), (37, 20, 45), (130, 300, 33)]


def matmul_operands(m, n, k):
    """f32 operands, a third of them exact ties of the TF32 rounding (bit
    12 set, bits 0-11 clear), where to nearest even and ties away part."""
    rng = np.random.RandomState(m + n + k)

    def draw(shape):
        v = rng.uniform(-1, 1, shape).astype(np.float32)
        u = v.view(np.uint32)
        ties = rng.uniform(size=shape) < 1 / 3
        u[ties] = (u[ties] & np.uint32(0xffffe000)) | np.uint32(0x1000)
        return u.view(np.float32)
    return draw((m, k)), draw((n, k))


@pytest.mark.parametrize('m,n,k', MATMUL_SHAPES)
def test_emulated_tf32_products_match_float64(m, n, k, emulated):
    """The f32 policy's tc_gemm alone: one product (hi hi) gives the
    float64 product of the operands rounded by tf32_rna, to f32
    accumulation; three (lo hi + hi lo + hi hi) the float64 product of the
    f32 operands within 1e-5 + 1e-5 rel, where one product errs past
    1e-4."""
    a, b = matmul_operands(m, n, k)
    got1 = fm.tc_matmul_f32(torch.from_numpy(a), torch.from_numpy(b), 1)
    got3 = fm.tc_matmul_f32(torch.from_numpy(a), torch.from_numpy(b), 3)
    want1 = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64).T
    want3 = a.astype(np.float64) @ b.astype(np.float64).T
    np.testing.assert_allclose(got1.numpy(), want1, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got3.numpy(), want3, rtol=1e-5, atol=1e-5)
    assert np.abs(got1.numpy() - want3).max() > 1e-4


# ------ the two kernels ------

def test_emulated_f32_rules_take_the_tensor_cores(emulated, monkeypatch):
    """f32 K1-fwd alone from F32_TC_MIN_ROWS rows (lowered to 3 here) and
    f32 K1-bwd with dx only on the sigma chains launch the split-TF32
    entries (one launch each, counted on their own counters), a forward
    alone below that size the CUDA-core entry; f32 with dx and dW keeps
    the CUDA-core K1-bwd and, under autograd, the CUDA-core K1-fwd before
    it, which the backward recomputes; under autograd with dx alone both
    run split TF32 whatever the size (with dW alone too:
    tests/test_torch_f32_dw_tc.py)."""
    _, _, plan, p, x, dy = case(SIGMA_NARROW, 3, 40)
    x, dy = torch.from_numpy(x), torch.from_numpy(dy)
    monkeypatch.setattr(fm, 'F32_TC_MIN_ROWS', 3)
    _, calls = calls_of(lambda: fm.chain_kernel(plan, x[:2], p))
    assert 'nfk_chain_fwd' in calls and 'nfk_chain_fwd_tc_f32' not in calls
    before = (fm.chain_kernel.f32_tc_launches, fm.chain_kernel.tc_launches,
              fm.chain_kernel_bwd.dx_tc_launches,
              fm.chain_kernel_bwd.tc_launches)
    _, calls = calls_of(lambda: fm.chain_kernel(plan, x, p))
    assert 'nfk_chain_fwd_tc_f32' in calls and 'nfk_chain_fwd' not in calls
    _, calls = calls_of(lambda: fm.chain_kernel_bwd(plan, x, dy, p,
                                                    needs_dw=False))
    assert calls[-1] == 'nfk_chain_bwd_dx_tc_f32' \
        and 'nfk_chain_bwd' not in calls
    assert (fm.chain_kernel.f32_tc_launches, fm.chain_kernel.tc_launches,
            fm.chain_kernel_bwd.dx_tc_launches,
            fm.chain_kernel_bwd.tc_launches) == (
        before[0] + 1, before[1], before[2] + 1, before[3])
    _, calls = calls_of(lambda: fm.chain_kernel_bwd(plan, x, dy, p))
    assert calls[-1] == 'nfk_chain_bwd'
    monkeypatch.setattr(fm, 'F32_TC_MIN_ROWS', 1 << 30)
    for needs_dw, fwd, bwd in (
            (True, 'nfk_chain_fwd', 'nfk_chain_bwd'),
            (False, 'nfk_chain_fwd_tc_f32', 'nfk_chain_bwd_dx_tc_f32')):
        w0 = p[0][0].clone().requires_grad_(needs_dw)
        xg = x.clone().requires_grad_()
        y, calls = calls_of(lambda: kernel_apply_chain(
            plan, xg, [(w0, p[0][1])] + p[1:], needs_dw=needs_dw))
        other = ({'nfk_chain_fwd', 'nfk_chain_fwd_tc_f32'} - {fwd}).pop()
        assert fwd in calls and other not in calls
        _, calls = calls_of(lambda: y.backward(dy))
        assert calls[-1] == bwd
    assert fm.fwd_on_tensor_cores(fm.make_plan(*SIGMA_FULL), None, CPU)
    assert fm.bwd_on_tensor_cores(fm.make_plan(*SIGMA_FULL), None, True,
                                  False, CPU)


@functools.lru_cache(maxsize=None)
def narrow_case(seed=41):
    """The narrow sigma chain's case at 130 rows with the Pallas kernels'
    output and dx, computed once for the tests that read them."""
    jplan, jp, plan, p, x, dy = case(SIGMA_NARROW, 130, seed)
    return plan, p, x, dy, pallas_fwd_dx(jplan, jp, x, dy)


def test_emulated_f32_kernels_match_interpreted_pallas_kernel(emulated,
                                                            monkeypatch):
    """On the narrow sigma chain at 130 rows: the split-TF32 K1-fwd within
    FWD_TOL elementwise and the dx-only K1-bwd within DX_TOL by relative
    norm of the Pallas kernels in interpret mode (f32, needs_dw=False) and
    of the plain version in float64; both bit-identical across two
    launches, and what chain_kernel (from F32_TC_MIN_ROWS rows, lowered to
    the case's 130) and chain_kernel_bwd launch. (Readings,
    seeds 41-43: the kernel 1.6-2.3e-7 from float64 by relative norm of
    dx; the Pallas kernel 1.7e-5, 2.4e-5 and, at seed 43, 3.8e-3 from
    float64, its double-angle trig gating one unit the other way, which
    the plain f32 version and the CUDA-core kernel read as well.)"""
    plan, p, x, dy, (y_want, dx_want) = narrow_case()
    y, dx = kernel_fwd_dx(plan, p, x, dy)
    np.testing.assert_allclose(y, y_want, **FWD_TOL)
    assert rel_norm(dx, dx_want) <= DX_TOL
    y64, dx64 = plain_fwd_dx_f64(plan, p, x, dy)
    np.testing.assert_allclose(y, y64, **FWD_TOL)
    assert rel_norm(dx, dx64) <= DX_TOL
    xt, dyt = torch.from_numpy(x), torch.from_numpy(dy)
    monkeypatch.setattr(fm, 'F32_TC_MIN_ROWS', x.shape[0])
    assert np.array_equal(fm.chain_kernel(plan, xt, p).numpy(), y)
    assert np.array_equal(
        fm.chain_kernel_bwd(plan, xt, dyt, p, needs_dw=False)[0].numpy(), dx)


def test_emulated_tf32_control_breaks_the_dx_limit(emulated):
    """Plain TF32 (hi hi alone) is no f32 design: its dx parts from the
    Pallas kernel's by more than DX_TOL (readings: ``python -m
    tests.test_torch_f32_tc``)."""
    plan, p, x, dy, (_, dx_want) = narrow_case()
    dx = fm.chain_kernel_bwd_dx_f32_tc(plan, torch.from_numpy(x),
                                       torch.from_numpy(dy), p, 1)
    assert rel_norm(dx, dx_want) > DX_TOL


def plain_fwd_dx_f64(plan, p, x, dy):
    """The plain version's output and dx (autograd of it) in float64."""
    xd = torch.from_numpy(x).double().requires_grad_()
    y = fm.chain_reference(plan, xd, [(w.double(), b.double()) for w, b in p])
    dx, = torch.autograd.grad(y, xd, torch.from_numpy(dy).double())
    return y.detach().numpy(), dx.numpy()


def test_emulated_f32_dx_at_sigma_width(emulated):
    """At nerf.ini's width (8 x 256: the ~175 KB dx block, and the skip
    consumer's 319 columns as two products with one activation buffer),
    one ragged tile of 40 rows: the dx-only K1-bwd, whose recompute is the
    forward's loop, within DX_TOL of the plain version in float64."""
    _, _, plan, p, x, dy = case(SIGMA_FULL, 40, 44)
    _, dx_want = plain_fwd_dx_f64(plan, p, x, dy)
    dx = fm.chain_kernel_bwd_dx_f32_tc(plan, torch.from_numpy(x),
                                       torch.from_numpy(dy), p)
    assert rel_norm(dx, dx_want) <= DX_TOL


def kernel_apply_chain(plan, x, params, force_reference=False,
                       compute_dtype=None, needs_dx=True, needs_dw=True):
    """fused_mlp.apply_chain as it runs on a CUDA tensor (the route's
    kernels under autograd), on CPU tensors for the emulation."""
    params = [(w, b) for w, b in params]
    flat = [t for pair in params for t in pair]
    if fm.needs_autograd([x] + flat):
        return fm.ChainFunction.apply(plan, compute_dtype, needs_dx, needs_dw,
                                      False, x, *flat)
    return fm._forward(plan, x, params, compute_dtype, False)[0]


def test_emulated_depth_normal_block_matches_jax(emulated, monkeypatch):
    """Distillation's depth/normal block on the emulated kernels (the
    model's eval_sigma through the chain's kernels, as on the card: two
    f32 tensor-core K1-fwd launches and one dx-only K1-bwd a block, no
    CUDA-core K1-bwd) against the JAX package's block, at
    test_depth_normal_block_matches_jax's limits: occupancy and depth
    within 1e-5 + 1e-5 rel, normals 1e-4 by relative norm. Two rays make
    a block of 256 coarse rows: F32_TC_MIN_ROWS is lowered to 0 so that
    the coarse forward runs as at the card's block sizes, from 104,960
    rows."""
    from tests.test_torch_geometry import distiller_pair, t, view_rays
    monkeypatch.setattr(fm, 'F32_TC_MIN_ROWS', 0)
    jd, td = distiller_pair()
    rayo, rayd = (a[31:33] for a in view_rays())
    want = jax.jit(jd._depth_normal_block_fn)(jnp.asarray(rayo),
                                              jnp.asarray(rayd))
    monkeypatch.setattr(fm, 'apply_chain', kernel_apply_chain)
    got, calls = calls_of(lambda: td.depth_normal_block(t(rayo), t(rayd)))
    assert calls.count('nfk_chain_fwd_tc_f32') == 2 \
        and calls.count('nfk_chain_bwd_dx_tc_f32') == 1 \
        and 'nfk_chain_bwd' not in calls and 'nfk_chain_fwd' not in calls
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    assert rel_norm(got[2], want[2]) <= 1e-4


# ------ readings ------

def readings(seeds=(41, 42, 43)):
    """The kernels' and the control's errors, forward max abs and dx
    relative norm: on the narrow sigma chain against the Pallas kernel
    (and the Pallas kernel's against float64), at full width against the
    plain version in float64."""
    from tests.test_torch_emu import emulated_library
    import tempfile
    out = []
    with tempfile.TemporaryDirectory() as tmp, emulated_library(tmp):
        for name, args, n in (('narrow', SIGMA_NARROW, 130),
                              ('full', SIGMA_FULL, 40)):
            for seed in seeds:
                jplan, jp, plan, p, x, dy = case(args, n, seed)
                y64, dx64 = plain_fwd_dx_f64(plan, p, x, dy)
                y_want, dx_want = pallas_fwd_dx(jplan, jp, x, dy) \
                    if name == 'narrow' else (y64, dx64)
                row = {'plan': name, 'rows': n, 'seed': seed}
                if name == 'narrow':
                    row['pallas_vs_f64'] = {
                        'fwd_max_abs': float(np.abs(y_want - y64).max()),
                        'dx_rel_norm': float(rel_norm(dx_want, dx64))}
                for terms in (3, 1):
                    y, dx = kernel_fwd_dx(plan, p, x, dy, terms)
                    row['tf32x%d' % terms] = {
                        'fwd_max_abs': float(np.abs(y - y_want).max()),
                        'dx_rel_norm': float(rel_norm(dx, dx_want))}
                out.append(row)
    return out


if __name__ == '__main__':
    for r in readings():
        print(json.dumps(r))
