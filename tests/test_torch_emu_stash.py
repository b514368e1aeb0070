"""bf16 K1r-fwd and K1r-bwd with dW only on the tensor cores, the stash
route's kernels (``csrc/fused_mlp.cu``'s ``chain_stash_fwd_tc_kernel``, and
``chain_stash_bwd_tc_kernel`` with the dW pass), run on the CPU through the
g++ emulation of the CUDA sources (``test_torch_emu.emulated_library``)
against the emulated CUDA-core K1r kernels and the JAX Pallas kernels
(``_pallas_forward_trig`` / ``_pallas_backward_trig``) in interpret mode,
at ``test_torch_chain``'s plans (widths 16 and 32) and the lvis chain at
128, on 1-130 rows; the launches the rules keep on the CUDA cores; and,
under autograd, the transposed weights the forward hands to the backward.

  JAX_PLATFORMS=cpu python -m tests.test_torch_emu_stash

prints the readings behind the bounds here.
"""

import argparse
import json
import tempfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm
from tests.test_torch_chain import PLANS, TOL, rel_norm
from tests.test_torch_chain_routes import case, jax_stash_route
from tests.test_torch_chain_tc import TC_PLANS
from tests.test_torch_emu import CALLS, PALLAS_TOL_BF16, emulated_library

BF16 = torch.bfloat16
STASH_PLANS = dict(PLANS, lvis128=TC_PLANS['lvis'])
SIZES = (1, 63, 64, 65, 130)


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    with emulated_library(str(tmp_path_factory.mktemp('emu'))):
        yield


def stash_case(name, n, seed):
    """Both packages' plan and weights, x and dy (torch) from ``seed``."""
    jplan, jp, tplan, tp, x, dy = case(STASH_PLANS[name], n, seed)
    return jplan, jp, tplan, tp, torch.from_numpy(x), torch.from_numpy(dy)


def launched(run):
    """``run()``'s output and the library entries it called."""
    del CALLS[:]
    out = run()
    return out, list(CALLS)


def tc_fwd(plan, x, p):
    """bf16 K1r-fwd with the stash, checking that it ran the tensor-core
    entry: (y, stash)."""
    out, calls = launched(lambda: fm.chain_kernel_stash(plan, x, p, BF16,
                                                        with_stash=True))
    assert 'nfk_chain_stash_fwd_tc' in calls and 'nfk_chain_fwd' not in calls
    return out


def tc_bwd(plan, x, dy, stash, p):
    """bf16 K1r-bwd with dW only, checking that it ran the tensor-core
    entry: [dW0, db0, ...]."""
    (dx, dparams), calls = launched(lambda: fm.chain_kernel_stash_bwd(
        plan, x, dy, stash, p, BF16, needs_dx=False))
    assert 'nfk_chain_stash_bwd_tc' in calls and 'nfk_chain_bwd' not in calls
    assert dx is None
    return [t for pair in dparams for t in pair]


def leaves(dparams):
    return [t for pair in dparams for t in pair]


def worst(got, want):
    return max(rel_norm(g, w) for g, w in zip(got, want))


# The tensor-core kernels against the emulated CUDA-core K1r kernels, which
# round at the same places. The emulated mma sums its products in K order
# with fmaf, as the CUDA-core loops do, so only the order of the head's
# and the dW pass's sums moves them apart; both compute the stash from the
# same f32 argument with sinf. Readings (python -m tests.test_torch_emu_stash,
# STASH_PLANS at 1-130 rows, seeds 50, 150, 250): the forward <= 3.3e-8,
# dW/db <= 5.2e-6 (worst leaf), the stash equal bit for bit. On the card,
# mma.sync's order of sums moves both (test_torch_chain_tc's card bounds).
TC_VS_CUDA_CORE_FWD_TOL = 1e-5
TC_VS_CUDA_CORE_DW_TOL = 0.01


@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('name', sorted(STASH_PLANS))
def test_emulated_tc_stash_kernels_match_cuda_core(name, n, emulated):
    """The tensor-core K1r-fwd within TC_VS_CUDA_CORE_FWD_TOL of the
    CUDA-core kernel and its stash equal bit for bit; the tensor-core
    K1r-bwd over that stash, every dW/db leaf within TC_VS_CUDA_CORE_DW_TOL
    of the CUDA-core kernel's. 64-row tiles: one partial, one short of
    whole, one whole, one and a row, two and two rows."""
    _, _, plan, p, x, dy = stash_case(name, n, seed=50)
    y, stash = tc_fwd(plan, x, p)
    y_core, stash_core = fm.chain_kernel_stash_cuda_core(plan, x, p, BF16,
                                                         with_stash=True)
    assert rel_norm(y, y_core) <= TC_VS_CUDA_CORE_FWD_TOL
    assert stash.dtype == BF16 and torch.equal(stash, stash_core)
    core = leaves(fm.chain_kernel_stash_bwd_cuda_core(
        plan, x, dy, stash, p, BF16, needs_dx=False)[1])
    got = tc_bwd(plan, x, dy, stash, p)
    assert [g.shape for g in got] == [c.shape for c in core]
    assert worst(got, core) <= TC_VS_CUDA_CORE_DW_TOL


# The Pallas stash-route kernels round where the tensor-core K1r does (the
# trig columns and posts at bf16, d_h in f32, d_pre in bf16). Readings
# (python -m tests.test_torch_emu_stash, pallas_readings: STASH_PLANS at 65
# and 130 rows, seeds 51, 151, 251): the output <= 1.4e-4 (relative norm;
# held elementwise by TOL), the worst dW/db leaf <= 1.1e-4, where the f32
# K1r-bwd, a kernel that computed the f32 gradient, reads >= 0.015 at 130
# rows (but 0.0048 on brdf_z at 65 rows, where the bound does not part the
# two; hence 130 rows here).
@pytest.mark.parametrize('name', sorted(STASH_PLANS))
def test_emulated_tc_stash_kernels_match_interpreted_pallas_kernel(name,
                                                                  emulated):
    """bf16 K1r-fwd on the tensor cores within TOL of the Pallas
    _pallas_forward_trig in interpret mode, its stash one bf16 step from
    the Pallas stash; K1r-bwd with dW only, every dW/db leaf within
    PALLAS_TOL_BF16 of _pallas_backward_trig's."""
    jplan, jp, plan, p, x, dy = stash_case(name, 130, seed=51)
    y_j, stash_j, dx_j, dw_j = jax_stash_route(
        jplan, jp, x.numpy(), dy.numpy(), jnp.bfloat16, needs_dx=False)
    assert dx_j is None
    dw_j = [torch.tensor(w) for w in dw_j]
    y, stash = tc_fwd(plan, x, p)
    np.testing.assert_allclose(y.numpy(), y_j, **TOL['bf16'])
    np.testing.assert_allclose(stash.float().numpy(), stash_j, rtol=0,
                               atol=2 ** -8)
    got = tc_bwd(plan, x, dy, stash, p)
    assert [g.shape for g in got] == [w.shape for w in dw_j]
    assert worst(got, dw_j) <= PALLAS_TOL_BF16


@pytest.mark.parametrize('name', sorted(STASH_PLANS))
def test_emulated_tc_stash_bwd_is_bit_identical_across_launches(name,
                                                                emulated):
    _, _, plan, p, x, dy = stash_case(name, 130, seed=52)
    _, stash = tc_fwd(plan, x, p)
    a, b = (tc_bwd(plan, x, dy, stash, p) for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_emulated_stash_route_keeps_f32_and_dx_on_the_cuda_cores(emulated):
    """The launches the rules keep on the CUDA-core K1r kernels: f32 (both
    kernels) and bf16 K1r-bwd with dx; each bit-identical to the CUDA-core
    wrappers' launch and counted once, with no tensor-core launch."""
    _, _, plan, p, x, dy = stash_case('lvis128', 65, seed=53)
    counts = (fm.chain_kernel_stash.launches, fm.chain_kernel_stash.tc_launches,
              fm.chain_kernel_stash_bwd.launches,
              fm.chain_kernel_stash_bwd.tc_launches)
    (y, stash), calls = launched(lambda: fm.chain_kernel_stash(
        plan, x, p, None, with_stash=True))
    assert calls == ['nfk_chain_fwd']
    y_core, stash_core = fm.chain_kernel_stash_cuda_core(plan, x, p, None,
                                                         with_stash=True)
    assert torch.equal(y, y_core) and torch.equal(stash, stash_core)
    _, bf16_stash = tc_fwd(plan, x, p)
    for cd, st, needs_dx in ((None, stash, False), (None, stash, True),
                             (BF16, bf16_stash, True)):
        got, calls = launched(lambda: fm.chain_kernel_stash_bwd(
            plan, x, dy, st, p, cd, needs_dx=needs_dx))
        assert calls[-1] == 'nfk_chain_bwd' and 'nfk_chain_stash_bwd_tc' \
            not in calls
        want = fm.chain_kernel_stash_bwd_cuda_core(plan, x, dy, st, p, cd,
                                                   needs_dx=needs_dx)
        assert (got[0] is None) == (not needs_dx)
        if needs_dx:
            assert torch.equal(got[0], want[0])
        assert all(torch.equal(a, b) for a, b in zip(leaves(got[1]),
                                                     leaves(want[1])))
    assert (fm.chain_kernel_stash.launches, fm.chain_kernel_stash.tc_launches,
            fm.chain_kernel_stash_bwd.launches,
            fm.chain_kernel_stash_bwd.tc_launches) == (
        counts[0] + 2, counts[1] + 1, counts[2] + 3, counts[3])


def test_emulated_stash_function_hands_packed_weights_to_backward(
        emulated, monkeypatch):
    """The chain's autograd Function on the stash route in bf16 with dW
    only packs the transposed weights once, in the tensor-core K1r-fwd,
    and its backward launches the tensor-core K1r-bwd over them and over
    the forward's stash: the dW/db of a launch that packs its own."""
    _, _, plan, p, x, dy = stash_case('lvis', 65, seed=54)
    packs, pack = [], fm.transposed_weights

    def counted(*args):
        packs.append(pack(*args))
        return packs[-1]
    monkeypatch.setattr(fm, 'transposed_weights', counted)
    flat = [t.clone().requires_grad_() for pair in p for t in pair]
    (y, calls) = launched(lambda: fm.ChainFunction.apply(
        plan, BF16, False, True, True, x, *flat))
    assert calls[-1] == 'nfk_chain_stash_fwd_tc'
    grads, bwd_calls = launched(lambda: torch.autograd.grad(y, flat, dy))
    assert len(packs) == 1 and packs[0] is y.grad_fn.wt
    assert bwd_calls[-1] == 'nfk_chain_stash_bwd_tc' \
        and 'nfk_chain_bwd' not in bwd_calls
    _, stash = fm.chain_kernel_stash(plan, x, p, BF16, with_stash=True)
    want = leaves(fm.chain_kernel_stash_bwd(plan, x, dy, stash, p, BF16,
                                            needs_dx=False)[1])
    assert all(torch.equal(g, w) for g, w in zip(grads, want))


def readings(seeds=(50, 150, 250), sizes=SIZES):
    """Per plan and size, over ``seeds``: the tensor-core K1r-fwd's output
    and K1r-bwd's worst dW/db leaf against the emulated CUDA-core kernels
    (relative norm), and whether the two stashes are equal."""
    out = []
    for name in sorted(STASH_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n, 'fwd_vs_cuda_core': 0.0,
                 'dw_vs_cuda_core': 0.0, 'stash_equal': True}
            for seed in seeds:
                _, _, plan, p, x, dy = stash_case(name, n, seed)
                y, stash = tc_fwd(plan, x, p)
                y_core, stash_core = fm.chain_kernel_stash_cuda_core(
                    plan, x, p, BF16, with_stash=True)
                core = leaves(fm.chain_kernel_stash_bwd_cuda_core(
                    plan, x, dy, stash, p, BF16, needs_dx=False)[1])
                r['fwd_vs_cuda_core'] = max(r['fwd_vs_cuda_core'],
                                            rel_norm(y, y_core))
                r['dw_vs_cuda_core'] = max(r['dw_vs_cuda_core'], worst(
                    tc_bwd(plan, x, dy, stash, p), core))
                r['stash_equal'] &= torch.equal(stash, stash_core)
            out.append(r)
    return out


def pallas_readings(seeds=(51, 151, 251), sizes=(65, 130)):
    """Per plan and size, over ``seeds``: the tensor-core K1r-fwd's output
    and K1r-bwd's worst dW/db leaf against the Pallas kernels' in bf16 in
    interpret mode, and the least reading of the f32 K1r-bwd (the
    control)."""
    out = []
    for name in sorted(STASH_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n, 'fwd_vs_pallas': 0.0,
                 'tc_dw_vs_pallas': 0.0, 'f32_kernel_dw_vs_pallas': np.inf}
            for seed in seeds:
                jplan, jp, plan, p, x, dy = stash_case(name, n, seed)
                y_j, _, _, dw_j = jax_stash_route(
                    jplan, jp, x.numpy(), dy.numpy(), jnp.bfloat16,
                    needs_dx=False)
                dw_j = [torch.tensor(w) for w in dw_j]
                y, stash = tc_fwd(plan, x, p)
                _, stash32 = fm.chain_kernel_stash(plan, x, p, None,
                                                   with_stash=True)
                f32 = leaves(fm.chain_kernel_stash_bwd(
                    plan, x, dy, stash32, p, None, needs_dx=False)[1])
                r['fwd_vs_pallas'] = max(r['fwd_vs_pallas'],
                                         rel_norm(y, torch.tensor(y_j)))
                r['tc_dw_vs_pallas'] = max(r['tc_dw_vs_pallas'], worst(
                    tc_bwd(plan, x, dy, stash, p), dw_j))
                r['f32_kernel_dw_vs_pallas'] = min(
                    r['f32_kernel_dw_vs_pallas'], worst(f32, dw_j))
            out.append(r)
    return out


def main():
    argparse.ArgumentParser(description=__doc__.split('\n\n')[0]).parse_args()
    with tempfile.TemporaryDirectory() as tmp, emulated_library(tmp):
        for r in readings() + pallas_readings():
            print(json.dumps(r))


if __name__ == '__main__':
    main()
