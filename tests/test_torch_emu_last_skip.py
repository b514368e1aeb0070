"""bf16 K1w-fwd and K1w-bwd on the tensor cores, the kernels of a plan with
a skip after its last layer (``csrc/fused_mlp.cu``'s
``chain_last_skip_fwd_tc_kernel``, and ``chain_last_skip_bwd_tc_kernel``
with the dW pass and the dx pass ``chain_dx_pass_kernel``), run on the CPU
through the g++ emulation of the CUDA sources
(``test_torch_emu.emulated_library``) against the emulated tensor-core K1
kernels on the same layers without the last skip, the emulated CUDA-core
K1w kernels and the JAX package's K1w route (``_pallas_forward`` /
``_pallas_backward``) in interpret mode. Plans: ``test_torch_chain``'s
(widths 16 and 32) with the skip moved after the head, one with a skip
consumer and a skip after the head, and the lvis chain at 128 with its
skip moved after the head, on 1-130 rows; f32 on the CUDA cores; under
autograd, the transposed weights the forward hands to the backward.

The JAX K1w route reads the global ``networks.MATMUL_DTYPE`` and ignores
a per-call bf16 (the documented deviation,
``test_torch_chain_routes.test_last_skip_bf16_deviation``). With that
global set to bf16 around the call (:func:`jax_last_skip_bf16`; nothing in
the JAX package is edited) its Pallas kernels round where the tensor-core
K1w does (posts and d_pre at bf16, d_h and d_e in f32), and they are the
oracle here: dW/db within 1e-6 of the emulated kernel, where the f32
kernel reads >= 0.016. Two of its outputs round elsewhere and are held
apart: its embedding columns stay f32 (the kernels write the bf16 values
their products read: one bf16 step), and its dx rounds each trig term of
the chain rule to bf16 in a bf16 product (``_dx_from_de``), which the
kernels sum in f32: ~0.0016 from the emulated kernel, where the f32
kernel reads 0.0015-0.013, so this bound does not part the two. dx's
rounding is held by the emulated CUDA-core K1w-bwd instead, which sums
d_e in the same order and reads 0 here (readings in
:data:`TC_VS_CUDA_CORE_DX_TOL`).

  JAX_PLATFORMS=cpu python -m tests.test_torch_emu_last_skip

prints the readings behind the bounds here.
"""

import argparse
import json
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.models import networks
from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu_torch.ops import fused_mlp as fm
from tests.test_torch_chain import TOL, rel_norm
from tests.test_torch_chain_routes import LAST_SKIP, case, jax_apply_grads
from tests.test_torch_chain_tc import TC_PLANS
from tests.test_torch_emu import CALLS, PALLAS_TOL_BF16, emulated_library

BF16 = torch.bfloat16
_LVIS = TC_PLANS['lvis']
LAST_SKIP_PLANS = dict(
    LAST_SKIP,
    both=([(3, 4), (3, 2)], (32,) * 4 + (1,), ('relu',) * 4 + ('sigmoid',),
          (2, 4)),
    lvis128=(_LVIS[0], _LVIS[1], _LVIS[2], (len(_LVIS[1]) - 1,)))
SIZES = (1, 63, 64, 65, 130)


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    with emulated_library(str(tmp_path_factory.mktemp('emu'))):
        yield


def last_skip_case(name, n, seed):
    """Both packages' plan and weights, x and dy (n, out_dim; torch) from
    ``seed``."""
    jplan, jp, tplan, tp, x, dy = case(LAST_SKIP_PLANS[name], n, seed)
    return jplan, jp, tplan, tp, torch.from_numpy(x), torch.from_numpy(dy)


def k1_plan(plan):
    """The same layers without the skip after the head: what K1 runs."""
    return plan._replace(skip_at=plan.skip_at[:-1])


def launched(run):
    """``run()``'s output and the library entries it called."""
    del CALLS[:]
    out = run()
    return out, list(CALLS)


def tc_fwd(plan, x, p):
    """bf16 K1w-fwd, checking that it ran the tensor-core entry."""
    y, calls = launched(lambda: fm.chain_kernel_last_skip(plan, x, p, BF16))
    assert 'nfk_chain_last_skip_fwd_tc' in calls and 'nfk_chain_fwd' \
        not in calls
    return y


def tc_bwd(plan, x, dy, p, needs_dx=True, needs_dw=True):
    """bf16 K1w-bwd, checking that it ran the tensor-core entry: (dx or
    None, [dW0, db0, ...] or None)."""
    (dx, dparams), calls = launched(lambda: fm.chain_kernel_last_skip_bwd(
        plan, x, dy, p, BF16, needs_dx, needs_dw))
    assert 'nfk_chain_last_skip_bwd_tc' in calls and 'nfk_chain_bwd' \
        not in calls
    assert (dx is None) != needs_dx and (dparams is None) != needs_dw
    return dx, leaves(dparams) if needs_dw else None


def k1_dw(plan, x, dy, p, cd=BF16):
    """K1-bwd's dW/db on the plan without the last skip, with dy's head
    columns (the tensor-core design in bf16)."""
    no = plan.widths[-1]
    return leaves(fm.chain_kernel_bwd(k1_plan(plan), x, dy[:, :no].contiguous(),
                                      p, cd, needs_dx=False)[1])


def cuda_core_dx(plan, x, dy, p, cd=BF16):
    return fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p, cd,
                                                   needs_dw=False)[0]


def leaves(dparams):
    return [t for pair in dparams for t in pair]


def same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def worst(got, want):
    return max(rel_norm(g, w) for g, w in zip(got, want))


# dx of the tensor-core K1w-bwd against the CUDA-core one, relative norm:
# the tensor-core limit of K1-bwd (test_torch_chain_tc's
# TC_VS_CUDA_CORE_TOL). Both round d_pre at bf16 and sum d_e in f32 in the
# same order; the emulated mma sums its products in K order with fmaf, as
# the CUDA-core loops do, so only the d_pre that the two phase-1 heads
# round apart could move them. Readings (python -m
# tests.test_torch_emu_last_skip, LAST_SKIP_PLANS at 1-130 rows, seeds 60,
# 160, 260): 0 (bit for bit); the f32 kernel (the control) 4.8e-5-0.0023.
TC_VS_CUDA_CORE_DX_TOL = 0.01


@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('name', sorted(LAST_SKIP_PLANS))
def test_emulated_tc_last_skip_kernels_match_k1_and_cuda_core(name, n,
                                                              emulated):
    """bf16 K1w-fwd on the tensor cores: its head column the tensor-core
    K1-fwd's on the plan without the last skip and its embedding columns
    the CUDA-core K1w-fwd's, bit for bit. bf16 K1w-bwd with dx and dW on
    the tensor cores: dW/db the tensor-core K1-bwd's with dy's head
    columns, bit for bit; dx within TC_VS_CUDA_CORE_DX_TOL of the
    CUDA-core K1w-bwd's. 64-row tiles: one partial, one short of whole, one
    whole, one and a row, two and two rows."""
    _, _, plan, p, x, dy = last_skip_case(name, n, seed=60)
    no = plan.widths[-1]
    y = tc_fwd(plan, x, p)
    assert y.shape == (n, fm.out_dim(plan))
    assert torch.equal(y[:, :no], fm.chain_kernel(k1_plan(plan), x, p, BF16))
    assert torch.equal(y[:, no:], fm.chain_kernel_last_skip_cuda_core(
        plan, x, p, BF16)[:, no:])
    dx, dw = tc_bwd(plan, x, dy, p)
    assert same(dw, k1_dw(plan, x, dy, p))
    assert rel_norm(dx, cuda_core_dx(plan, x, dy, p)) \
        <= TC_VS_CUDA_CORE_DX_TOL


def jax_last_skip_bf16(jplan, jp, x, dy):
    """The JAX package's K1w route in interpret mode with
    ``networks.MATMUL_DTYPE`` bf16 for the call, under jax.vjp: (y, [dx,
    dW0, db0, ...]), NumPy."""
    old, pm.INTERPRET = networks.MATMUL_DTYPE, True
    networks.MATMUL_DTYPE = jnp.bfloat16
    try:
        return jax_apply_grads(pm.apply_chain, jplan, jp, x, dy)
    finally:
        networks.MATMUL_DTYPE, pm.INTERPRET = old, False


# Against jax_last_skip_bf16 (readings: python -m
# tests.test_torch_emu_last_skip, pallas_readings, LAST_SKIP_PLANS at 65
# and 130 rows, seeds 61, 161, 261): dW/db <= 1e-6 (the f32 kernel >=
# 0.016); the head column well inside TOL; the embedding columns one bf16
# step; dx ~0.0016 (the f32 kernel 0.0015-0.013: no part, see the module
# docstring).
@pytest.mark.parametrize('name', sorted(LAST_SKIP_PLANS))
def test_emulated_tc_last_skip_kernels_match_interpreted_pallas_kernel(
        name, emulated):
    """bf16 K1w on the tensor cores against the JAX K1w route in bf16
    (jax_last_skip_bf16): the head column within TOL, the embedding columns
    one bf16 step; with dx and dW, every dW/db leaf and dx within
    PALLAS_TOL_BF16 of their norms."""
    jplan, jp, plan, p, x, dy = last_skip_case(name, 130, seed=61)
    y_j, want = jax_last_skip_bf16(jplan, jp, x.numpy(), dy.numpy())
    no = plan.widths[-1]
    y = tc_fwd(plan, x, p).numpy()
    np.testing.assert_allclose(y[:, :no], y_j[:, :no], **TOL['bf16'])
    np.testing.assert_allclose(y[:, no:], y_j[:, no:], rtol=0, atol=2 ** -8)
    dx, dw = tc_bwd(plan, x, dy, p)
    want = [torch.tensor(w) for w in want]
    assert [g.shape for g in dw] == [w.shape for w in want[1:]]
    assert worst(dw, want[1:]) <= PALLAS_TOL_BF16
    assert rel_norm(dx, want[0]) <= PALLAS_TOL_BF16


@pytest.mark.parametrize('name', sorted(LAST_SKIP_PLANS))
def test_emulated_tc_last_skip_bwd_modes_are_bit_identical(name, emulated):
    """bf16 K1w-bwd on the tensor cores with dx only (phase 1 and the dx
    pass) and with dW only (phase 1 and the dW pass) gives the dx and the
    dW/db of a launch with both, and a second launch the same bits."""
    _, _, plan, p, x, dy = last_skip_case(name, 130, seed=62)
    dx, dw = tc_bwd(plan, x, dy, p)
    assert torch.equal(tc_bwd(plan, x, dy, p, needs_dw=False)[0], dx)
    assert same(tc_bwd(plan, x, dy, p, needs_dx=False)[1], dw)
    dx2, dw2 = tc_bwd(plan, x, dy, p)
    assert torch.equal(dx2, dx) and same(dw2, dw)


def last_skip_counts():
    return (fm.chain_kernel_last_skip.launches,
            fm.chain_kernel_last_skip.tc_launches,
            fm.chain_kernel_last_skip_bwd.launches,
            fm.chain_kernel_last_skip_bwd.tc_launches)


def test_emulated_last_skip_keeps_f32_on_the_cuda_cores(emulated):
    """f32 K1w-fwd and K1w-bwd (every flag combination) launch the
    CUDA-core kernels, bit-identical to the CUDA-core wrappers' launches,
    each counted once, with no tensor-core launch; bf16 launches count as
    tensor-core ones."""
    _, _, plan, p, x, dy = last_skip_case('lvis128', 65, seed=63)
    before = last_skip_counts()
    y, calls = launched(lambda: fm.chain_kernel_last_skip(plan, x, p))
    assert calls == ['nfk_chain_fwd']
    assert torch.equal(y, fm.chain_kernel_last_skip_cuda_core(plan, x, p))
    for flags in ((True, True), (True, False), (False, True)):
        (dx, dparams), calls = launched(lambda: fm.chain_kernel_last_skip_bwd(
            plan, x, dy, p, None, *flags))
        assert calls[-1] == 'nfk_chain_bwd' \
            and 'nfk_chain_last_skip_bwd_tc' not in calls
        want = fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p, None,
                                                       *flags)
        assert (dx is None) == (want[0] is None)
        assert dx is None or torch.equal(dx, want[0])
        assert (dparams is None) == (want[1] is None)
        assert dparams is None or same(leaves(dparams), leaves(want[1]))
    assert last_skip_counts() == (before[0] + 1, before[1], before[2] + 3,
                                  before[3])
    tc_fwd(plan, x, p)
    tc_bwd(plan, x, dy, p)
    assert last_skip_counts() == (before[0] + 2, before[1] + 1,
                                  before[2] + 4, before[3] + 1)


def test_emulated_last_skip_function_hands_packed_weights_to_backward(
        emulated, monkeypatch):
    """The chain's autograd Function on a last-skip plan in bf16 with dx
    and dW packs the transposed weights once, in the tensor-core K1w-fwd,
    and its backward launches the tensor-core K1w-bwd over them: the dx
    and dW/db of a launch that packs its own."""
    _, _, plan, p, x, dy = last_skip_case('both', 65, seed=64)
    packs, pack = [], fm.transposed_weights

    def counted(*args):
        packs.append(pack(*args))
        return packs[-1]
    monkeypatch.setattr(fm, 'transposed_weights', counted)
    xg = x.clone().requires_grad_()
    flat = [t.clone().requires_grad_() for pair in p for t in pair]
    y, calls = launched(lambda: fm.ChainFunction.apply(
        plan, BF16, True, True, False, xg, *flat))
    assert calls[-1] == 'nfk_chain_last_skip_fwd_tc'
    grads, bwd_calls = launched(lambda: torch.autograd.grad(y, [xg] + flat,
                                                            dy))
    assert len(packs) == 1 and packs[0] is y.grad_fn.wt
    assert bwd_calls[-1] == 'nfk_chain_last_skip_bwd_tc' \
        and 'nfk_chain_bwd' not in bwd_calls
    dx, dw = tc_bwd(plan, x, dy, p)
    assert torch.equal(grads[0], dx) and same(grads[1:], dw)


def readings(seeds=(60, 160, 260), sizes=SIZES):
    """Per plan and size, over ``seeds``: dx of the tensor-core K1w-bwd and
    of the f32 kernel (the control) against the emulated CUDA-core bf16
    K1w-bwd's (relative norm), and whether K1w's head column and dW/db are
    the tensor-core K1's and its embedding columns the CUDA-core K1w's,
    bit for bit."""
    out = []
    for name in sorted(LAST_SKIP_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n, 'dx_vs_cuda_core': 0.0,
                 'f32_dx_vs_cuda_core': np.inf, 'head_same_as_k1': True,
                 'embed_same_as_cuda_core': True, 'dw_same_as_k1': True}
            for seed in seeds:
                _, _, plan, p, x, dy = last_skip_case(name, n, seed)
                no = plan.widths[-1]
                y = tc_fwd(plan, x, p)
                dx, dw = tc_bwd(plan, x, dy, p)
                core = cuda_core_dx(plan, x, dy, p)
                r['dx_vs_cuda_core'] = max(r['dx_vs_cuda_core'],
                                           rel_norm(dx, core))
                r['f32_dx_vs_cuda_core'] = min(
                    r['f32_dx_vs_cuda_core'],
                    rel_norm(cuda_core_dx(plan, x, dy, p, None), core))
                r['head_same_as_k1'] &= torch.equal(
                    y[:, :no], fm.chain_kernel(k1_plan(plan), x, p, BF16))
                r['embed_same_as_cuda_core'] &= torch.equal(
                    y[:, no:], fm.chain_kernel_last_skip_cuda_core(
                        plan, x, p, BF16)[:, no:])
                r['dw_same_as_k1'] &= same(dw, k1_dw(plan, x, dy, p))
            out.append(r)
    return out


def pallas_readings(seeds=(61, 161, 261), sizes=(65, 130)):
    """Per plan and size, over ``seeds``: the tensor-core K1w against the
    JAX K1w route in bf16 (jax_last_skip_bf16): the head column's and the
    embedding columns' max error, dx and the worst dW/db leaf (relative
    norm), with the least readings of the f32 kernels (the control)."""
    out = []
    for name in sorted(LAST_SKIP_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n, 'head_max_abs_err': 0.0,
                 'embed_max_abs_err': 0.0, 'dx_vs_pallas': 0.0,
                 'dw_vs_pallas': 0.0, 'f32_kernel_dx_vs_pallas': np.inf,
                 'f32_kernel_dw_vs_pallas': np.inf}
            for seed in seeds:
                jplan, jp, plan, p, x, dy = last_skip_case(name, n, seed)
                y_j, want = jax_last_skip_bf16(jplan, jp, x.numpy(),
                                               dy.numpy())
                want = [torch.tensor(w) for w in want]
                no = plan.widths[-1]
                err = np.abs(tc_fwd(plan, x, p).numpy() - y_j)
                dx, dw = tc_bwd(plan, x, dy, p)
                dx32, dw32 = fm.chain_kernel_last_skip_bwd(plan, x, dy, p)
                for key, val, agg in (
                        ('head_max_abs_err', err[:, :no].max(), max),
                        ('embed_max_abs_err', err[:, no:].max(), max),
                        ('dx_vs_pallas', rel_norm(dx, want[0]), max),
                        ('dw_vs_pallas', worst(dw, want[1:]), max),
                        ('f32_kernel_dx_vs_pallas', rel_norm(dx32, want[0]),
                         min),
                        ('f32_kernel_dw_vs_pallas',
                         worst(leaves(dw32), want[1:]), min)):
                    r[key] = agg(r[key], float(val))
            out.append(r)
    return out


def main():
    argparse.ArgumentParser(description=__doc__.split('\n\n')[0]).parse_args()
    with tempfile.TemporaryDirectory() as tmp, emulated_library(tmp):
        for r in readings() + pallas_readings():
            print(json.dumps(r))


if __name__ == '__main__':
    main()
