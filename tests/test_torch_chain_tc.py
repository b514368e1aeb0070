"""bf16 K1-fwd and K1-bwd with dW only on the tensor cores: the forward
``nfk_chain_fwd_tc`` and the backward's design (phase 1 and the dW pass,
``nfk_chain_bwd_tc``), which the joint step's lvis chain runs; and the
stash route's K1r-fwd and K1r-bwd on them (``nfk_chain_stash_fwd_tc``,
``nfk_chain_stash_bwd_tc``).

On the CPU: the rules that send a K1 or K1r launch to them and the
scratch's layout, all asked of the g++ emulation of the CUDA sources
(``test_torch_emu`` and ``test_torch_emu_stash``, where the kernels
themselves are held against the Pallas kernels), and the zero padding
that takes hidden widths off the mma step (16) onto it. On a card (the
``cuda`` marker; they skip here): the kernels at the lvis chain's width
(128 x 4, the embedding concatenated after layer 2, a 1-wide sigmoid
head), past one column pass (272) and off the mma step (24), against the
CUDA-core kernels and the plain version (autograd of it for the
backward), bit-identical across launches (K1r's stash bit-identical to
the CUDA-core kernel's); and the plans the rules keep on the CUDA-core
kernels.

  python -m tests.test_torch_chain_tc [--seeds 40,41,42,43]

prints, on a card, the readings behind the card tests' bf16 bounds.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm
from tests.test_torch_chain import (
    PLANS, TOL, both, chain_inputs, rel_norm)

# The lvis chain at the shipped nerfactor.ini widths
LVIS = ([(3, 10), (3, 4)], (128,) * 4 + (1,), ('relu',) * 4 + ('sigmoid',),
        (2,))
TC_PLANS = {
    'lvis': LVIS,
    'w272': ([(3, 4), (3, 2)], (272,) * 3 + (1,),
             ('relu',) * 3 + ('sigmoid',), (1,)),
    'w24': ([(3, 4), (3, 2)], (24,) * 4 + (2,), ('relu',) * 4 + (None,),
            (2,)),
}
# Two plans whose bf16 dW-only backward the rule keeps on the CUDA-core
# kernel: the embedding concatenated into a 1-wide sigmoid head (a skip
# consumer, which phase 1's tiny head does not take), and hidden layers of
# 704 (phase 1's block would pass the card's shared memory).
OFF_TC_PLANS = {
    'skip_head': ([(3, 4), (3, 2)], (32, 32, 1), ('relu', 'relu', 'sigmoid'),
                  (1,)),
    'w704': ([(3, 2)], (704, 704, 1), ('relu', 'relu', 'sigmoid'), (0,)),
}
BF16 = torch.bfloat16


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    """The kernel wrappers over the g++ emulation of the CUDA sources, on
    CPU tensors (test_torch_emu): the rule asks the library."""
    from tests.test_torch_emu import emulated_library  # it imports TC_PLANS
    with emulated_library(str(tmp_path_factory.mktemp('emu'))):
        yield


def test_bwd_on_tensor_cores_rule(emulated):
    """bf16 with dW only takes the tensor cores, on either route
    (test_stash_route_takes_the_rules), and so does a skip after the head
    (K1w) with dx or dW or both; f32 with dx only or with dW only (up to
    F32_DW_TC_MAX_ROWS rows) takes the f32 tensor-core design on K1's
    route where every hidden act is ReLU. f32 with dx and dW, f32 with dW
    past F32_DW_TC_MAX_ROWS rows, f32 on the stash route or with a skip
    after the head, f32 with a non-ReLU hidden layer, bf16 dx without a
    skip after the head, no dW and no dx, a skip into the head, a head
    wider than 8, a head-only chain and hidden layers too wide for phase
    1's block (640; 512 fits) keep the CUDA-core kernel."""
    plan = fm.make_plan(*LVIS)
    cpu = torch.device('cpu')

    def rule(pl, cd, needs_dx, needs_dw, stash_route=False, rows=None):
        return fm.bwd_on_tensor_cores(pl, cd, needs_dx, needs_dw, cpu,
                                      stash_route=stash_route, rows=rows)
    assert rule(plan, BF16, False, True)
    assert rule(fm.make_plan(*TC_PLANS['w24']), BF16, False, True)
    for cd in (None, torch.float32):
        assert rule(plan, cd, True, False)
        assert rule(plan, cd, False, True)
        assert rule(plan, cd, False, True, rows=fm.F32_DW_TC_MAX_ROWS)
        assert not rule(plan, cd, False, True,
                        rows=fm.F32_DW_TC_MAX_ROWS + 1)
        assert rule(plan, cd, True, False, rows=fm.F32_DW_TC_MAX_ROWS + 1)
        assert not rule(plan, cd, True, True)
        for needs_dx, needs_dw in ((True, False), (False, True)):
            assert not rule(plan, cd, needs_dx, needs_dw, stash_route=True)
            assert not rule(plan._replace(
                acts=('relu', 'softplus') + plan.acts[2:]), cd, needs_dx,
                needs_dw)
    assert rule(fm.make_plan(*TC_PLANS['w24']), None, True, False)
    assert not rule(plan, BF16, True, True)
    assert not rule(plan, BF16, True, False)
    assert not rule(plan, BF16, False, False)
    assert not rule(plan, None, False, False)
    for skip_at in ((4,), (2, 4)):
        last = plan._replace(skip_at=skip_at)
        for needs_dx, needs_dw in ((False, True), (True, True), (True, False)):
            assert rule(last, BF16, needs_dx, needs_dw)
            assert not rule(last, None, needs_dx, needs_dw)
        assert not rule(last, BF16, False, False)
    assert not rule(plan._replace(skip_at=(3,)), BF16, False, True)
    assert not rule(plan._replace(skip_at=(1, 3)), BF16, False, True)
    assert not rule(plan._replace(skip_at=(3, 4)), BF16, True, True)
    for head, ok in ((8, True), (9, False)):
        wide = plan._replace(widths=plan.widths[:-1] + (head,))
        assert rule(wide, BF16, False, True) == ok
    head_only = fm.make_plan([(3, 2)], (1,), ('sigmoid',), ())
    assert not rule(head_only, BF16, False, True)
    for width, ok in ((512, True), (640, False)):
        wide = plan._replace(widths=(width,) * 4 + plan.widths[-1:])
        assert rule(wide, BF16, False, True) == ok


def test_fwd_on_tensor_cores_rule(emulated):
    """bf16 K1-fwd takes the tensor cores, on either route
    (test_stash_route_takes_the_rules) and with a skip after the head
    (K1w), on the plans the backward's phase 1 takes (width 24 once
    padded); f32 K1-fwd takes the f32 tensor-core kernel on K1's route, on
    the same plans where its f32 block fits (256 wide; 512 does not),
    unless autograd's backward on it will run on the CUDA cores (dx and
    dW, dW past F32_DW_TC_MAX_ROWS rows, or a non-ReLU hidden layer);
    alone, from F32_TC_MIN_ROWS rows (under autograd the backward
    decides). f32 on the stash route or with
    a skip after the head, a skip into the head, a head wider than 8, a
    head-only chain and hidden layers too wide for the block (bf16: 640;
    512 fits) keep the CUDA-core kernel."""
    plan = fm.make_plan(*LVIS)
    cpu = torch.device('cpu')

    def rule(pl, cd, stash_route=False, backward=None, rows=None):
        return fm.fwd_on_tensor_cores(pl, cd, cpu, stash_route=stash_route,
                                      backward=backward, rows=rows)
    assert rule(plan, BF16)
    assert rule(fm.make_plan(*TC_PLANS['w24']), BF16)
    assert rule(plan, None)
    assert rule(plan, torch.float32)
    assert rule(fm.make_plan(*TC_PLANS['w24']), None)
    for backward, ok in (((True, False), True), ((False, False), True),
                         ((True, True), False), ((False, True), True)):
        assert rule(plan, None, backward=backward) == ok
        assert rule(plan, BF16, backward=backward)
    for rows, ok in ((1, False), (fm.F32_TC_MIN_ROWS - 1, False),
                     (fm.F32_TC_MIN_ROWS, True)):
        assert rule(plan, None, rows=rows) == ok
        assert rule(plan, None, backward=(False, False), rows=rows) == ok
        assert rule(plan, None, backward=(True, False), rows=rows)
        assert rule(plan, None, backward=(False, True), rows=rows) == (
            rows <= fm.F32_DW_TC_MAX_ROWS)
        assert not rule(plan, None, backward=(True, True), rows=rows)
        assert rule(plan, BF16, rows=rows)
    assert rule(plan, None, backward=(False, True),
                rows=fm.F32_DW_TC_MAX_ROWS)
    assert not rule(plan, None, backward=(False, True),
                    rows=fm.F32_DW_TC_MAX_ROWS + 1)
    softplus = plan._replace(acts=('relu', 'softplus') + plan.acts[2:])
    assert rule(softplus, None)
    assert not rule(softplus, None, backward=(True, False))
    assert not rule(softplus, None, backward=(False, True))
    assert not rule(plan, None, stash_route=True)
    assert rule(plan, BF16, stash_route=True)
    for skip_at in ((4,), (2, 4)):
        assert rule(plan._replace(skip_at=skip_at), BF16)
        assert not rule(plan._replace(skip_at=skip_at), None)
    for cd in (BF16, None):
        assert not rule(plan._replace(skip_at=(3,)), cd)
        assert not rule(plan._replace(skip_at=(3, 4)), cd)
        for head, ok in ((8, True), (9, False)):
            assert rule(plan._replace(widths=plan.widths[:-1] + (head,)),
                        cd) == ok
        assert not rule(fm.make_plan([(3, 2)], (1,), ('sigmoid',), ()), cd)
    for width, ok in ((512, True), (640, False)):
        assert rule(plan._replace(widths=(width,) * 4 + plan.widths[-1:]),
                    BF16) == ok
    for width, ok in ((256, True), (512, False)):
        assert rule(plan._replace(widths=(width,) * 4 + plan.widths[-1:]),
                    None) == ok


def entries(launch):
    """The library entries ``launch()`` calls (the emulation records
    them)."""
    from tests.test_torch_emu import CALLS
    del CALLS[:]
    launch()
    return list(CALLS)


def test_stash_route_takes_the_rules(emulated):
    """The stash route's launches ask K1's rules: bf16 K1r-fwd and bf16
    K1r-bwd without dx run the tensor-core entries; f32 K1r-fwd, and
    K1r-bwd with dx or in f32, the CUDA-core ones (the lvis chain, one
    row)."""
    _, _, plan, p = both(LVIS, seed=5)
    x = torch.from_numpy(chain_inputs(plan, n=1, seed=6))
    dy = torch.ones(1, 1)
    for cd, tc in ((BF16, True), (None, False)):
        stash = [None]

        def fwd():
            stash[0] = fm.chain_kernel_stash(plan, x, p, cd,
                                             with_stash=True)[1]
        calls = entries(fwd)
        assert ('nfk_chain_stash_fwd_tc' in calls) == tc \
            and ('nfk_chain_fwd' in calls) != tc
        for needs_dx in (False, True):
            calls = entries(lambda: fm.chain_kernel_stash_bwd(
                plan, x, dy, stash[0], p, cd, needs_dx=needs_dx))
            on_tc = tc and not needs_dx
            assert ('nfk_chain_stash_bwd_tc' in calls) == on_tc \
                and ('nfk_chain_bwd' in calls) != on_tc


def test_padded_plan_keeps_the_chain_and_its_gradients():
    """mma_plan rounds the hidden widths up to 16 and keeps the head's;
    the plain version over pad_params' weights gives the same output and,
    once unpadded, the same weight gradients (f32)."""
    _, _, plan, p = both(TC_PLANS['w24'], seed=7)
    kplan = fm.mma_plan(plan)
    assert kplan.widths == (32,) * 4 + (2,) and fm.mma_plan(kplan) == kplan
    assert fm.mma_plan(fm.make_plan(*LVIS)) == fm.make_plan(*LVIS)
    padded = fm.pad_params(plan, p)
    assert [tuple(w.shape) for w, _ in padded] == [
        (d, w) for d, w in zip(fm.layer_in_dims(kplan), kplan.widths)]
    for (a, b), (w, c) in zip(fm.unpad_grads(plan, padded), p):
        assert torch.equal(a, w) and torch.equal(b, c)
    x = torch.from_numpy(chain_inputs(plan, n=10, seed=8))
    dy = torch.from_numpy(np.random.RandomState(9).uniform(
        -1, 1, (10, 2)).astype(np.float32))

    def grads(pl, params):
        leaves = [t.clone().requires_grad_() for pair in params for t in pair]
        y = fm.chain_reference(pl, x, list(zip(leaves[0::2], leaves[1::2])))
        return y.detach(), torch.autograd.grad(y, leaves, dy)
    y, want = grads(plan, p)
    y_pad, got = grads(kplan, padded)
    np.testing.assert_allclose(y_pad.numpy(), y.numpy(), rtol=1e-6,
                               atol=1e-6)
    got = fm.unpad_grads(plan, list(zip(got[0::2], got[1::2])))
    for g, w in zip([t for pair in got for t in pair], want):
        assert g.shape == w.shape and rel_norm(g, w) <= 1e-6


def test_scratch_columns_and_dense_layers(emulated):
    """The lvis chain's scratch row as the library lays it out: the
    embedding (90, padded to 96), the posts of hidden layers 0-2, the d_pre
    of all four: 992 columns; the skip consumer (layer 3) reads [post 2 |
    embedding]; the dW pass takes 64-wide tiles."""
    plan = fm.make_plan(*LVIS)
    tab, tile = fm.chain_dw_table(plan, torch.device('cpu'))
    assert tab.total == 96 + 3 * 128 + 4 * 128 == 992 and tile == 64
    assert tab.n_dense == 90 * 128 + 2 * 128 * 128 + 218 * 128
    assert [(l.seg1, l.k1, l.seg2, l.k2, l.dpre, l.n, l.w_off)
            for l in tab.dense()] == [
        (0, 90, 0, 0, 480, 128, 0), (96, 128, 0, 0, 608, 128, 90 * 128),
        (224, 128, 0, 0, 736, 128, 218 * 128),
        (352, 128, 0, 90, 864, 128, 346 * 128)]
    assert fm.scratch_values(tab, 65) == 128 * 992
    ws = [torch.arange(d * w, dtype=torch.float32).view(d, w)
          for d, w in zip(fm.layer_in_dims(plan), plan.widths[:-1])]
    wt = fm.pack_transposed(ws, tab)
    assert wt.dtype == torch.bfloat16
    assert wt.numel() == 128 * (96 + 128 + 128 + 128 + 96)
    last = wt[-128 * 224:].view(128, 224).float()
    assert torch.equal(last[:, :128], ws[3][:128].t().bfloat16().float())
    assert torch.equal(last[:, 128:218], ws[3][128:].t().bfloat16().float())
    assert not last[:, 218:].any()


# ------ on the card ------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def card_case(plan_args, n, seed, device):
    _, _, plan, p = both(plan_args, seed=seed)
    x = torch.from_numpy(chain_inputs(plan, n=n, seed=seed + 1)).to(device)
    dy = torch.from_numpy(np.random.RandomState(seed + 2).uniform(
        -1, 1, (n, plan.widths[-1])).astype(np.float32)).to(device)
    return plan, [(w.to(device), b.to(device)) for w, b in p], x, dy


def leaves(dparams):
    return [t for pair in dparams for t in pair]


def plain_dparams(plan, x, dy, p, td, ref=fm.chain_reference):
    flat = [t.clone().requires_grad_() for t in leaves(p)]
    y = ref(plan, x, list(zip(flat[0::2], flat[1::2])), td)
    return torch.autograd.grad(y, flat, dy)


def worst(a, b):
    """The worst relative norm over the leaves of ``a`` against ``b``."""
    return max(rel_norm(u, v) for u, v in zip(a, b))


def recorded_calls(monkeypatch):
    """The library entries the wrappers call from now on, in order."""
    calls, run = [], fm.run

    def record(entry, *args, **kw):
        calls.append(entry)
        return run(entry, *args, **kw)
    monkeypatch.setattr(fm, 'run', record)
    return calls


# The two kernels round at the same places and sum in another order; on
# the card a d_pre that mma.sync's sum puts next to a bf16 rounding
# boundary rounds the other way. Readings (python -m
# tests.test_torch_chain_tc, seeds 40-43, the plans of both card tests at
# 1, 50 and 4,099 rows; NVIDIA H100 80GB HBM3, 700.00 W): the tensor-core
# kernel <= 0.0051 from the CUDA-core one (worst dW/db leaf; 1.2e-7 where
# no d_pre flips); on the stash route, K1r-bwd the same, <= 0.0051.
TC_VS_CUDA_CORE_TOL = 0.01
# Against autograd of the plain bf16 version, which rounds every cotangent
# at each cast: at these sizes the bf16 kernels read up to 0.145 (w24, 50
# rows; w272, 1 row: 0.113; K1r-bwd against the plain stash route the
# same), the f32 kernel as close (0.0046-0.10), as for K3's card tests
# (NERF_DW_TOL): the bound catches a wrong layer or layout (~1), the
# rounding policy is held by test_torch_emu and test_torch_emu_stash
# (against the TPU kernels) and chip_smoke.py (at the joint step's
# 1,048,576 rows).
TC_DW_TOL_BF16 = 0.25


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099, 70001])
@pytest.mark.parametrize('name', sorted(TC_PLANS))
def test_tc_bwd_on_card(name, n, cuda, monkeypatch):
    """One K1-bwd launch through the tensor-core entry: dW/db within
    TC_VS_CUDA_CORE_TOL of the CUDA-core kernel's, within TC_DW_TOL_BF16
    of autograd of the plain bf16 version, bit-identical across
    launches."""
    plan, p, x, dy = card_case(TC_PLANS[name], n, 60, cuda)
    calls = recorded_calls(monkeypatch)
    launches = fm.chain_kernel_bwd.launches
    got = leaves(fm.chain_kernel_bwd(plan, x, dy, p, BF16, needs_dx=False)[1])
    torch.cuda.synchronize()
    assert 'nfk_chain_bwd_tc' in calls and 'nfk_chain_bwd' not in calls
    assert fm.chain_kernel_bwd.launches == launches + 1
    core = leaves(fm.chain_kernel_bwd(plan, x, dy, p, BF16, needs_dx=True)[1])
    assert max(rel_norm(g, c) for g, c in zip(got, core)) \
        <= TC_VS_CUDA_CORE_TOL
    for g, w in zip(got, plain_dparams(plan, x, dy, p, BF16)):
        assert g.shape == w.shape and rel_norm(g, w) <= TC_DW_TOL_BF16
    again = leaves(fm.chain_kernel_bwd(plan, x, dy, p, BF16,
                                       needs_dx=False)[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize('name', sorted(OFF_TC_PLANS))
def test_off_tc_plans_keep_the_cuda_core_kernel_on_card(name, cuda,
                                                        monkeypatch):
    """bf16 K1-bwd with dW only on a plan that the rule keeps off the
    tensor cores launches the CUDA-core kernel, within TC_DW_TOL_BF16 of
    autograd of the plain bf16 version."""
    plan, p, x, dy = card_case(OFF_TC_PLANS[name], 4099, 60, cuda)
    calls = recorded_calls(monkeypatch)
    got = leaves(fm.chain_kernel_bwd(plan, x, dy, p, BF16, needs_dx=False)[1])
    torch.cuda.synchronize()
    assert 'nfk_chain_bwd' in calls and 'nfk_chain_bwd_tc' not in calls
    for g, w in zip(got, plain_dparams(plan, x, dy, p, BF16)):
        assert g.shape == w.shape and rel_norm(g, w) <= TC_DW_TOL_BF16


# The tensor-core K1-fwd against the CUDA-core one, relative norm of the
# output: both round the posts at bf16 and the head in f32 from them, in
# another order of sums, so on the card a post next to a bf16 rounding
# boundary may round the other way. Readings (python -m
# tests.test_torch_chain_tc, card_readings, seeds 40-43, TC_PLANS at 1, 50
# and 4,099 rows; NVIDIA H100 80GB HBM3, 700.00 W): the tensor-core kernel
# <= 2.7e-5 from the CUDA-core bf16 kernel, the f32 kernel (the control)
# >= 2.5e-4 (PLANS' widths 16 and 32 too: <= 1.7e-4 against >= 2.5e-4);
# K1r-fwd on the stash route the same, its stash equal bit for bit.
TC_FWD_VS_CUDA_CORE_TOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099, 70001])
@pytest.mark.parametrize('name', sorted(TC_PLANS))
def test_tc_fwd_on_card(name, n, cuda, monkeypatch):
    """One K1-fwd launch through the tensor-core entry, counted once:
    within TOL of the plain bf16 version, within TC_FWD_VS_CUDA_CORE_TOL
    of the CUDA-core kernel, bit-identical across launches."""
    plan, p, x, _ = card_case(TC_PLANS[name], n, 60, cuda)
    calls = recorded_calls(monkeypatch)
    launches = fm.chain_kernel.launches
    got = fm.chain_kernel(plan, x, p, BF16)
    torch.cuda.synchronize()
    assert 'nfk_chain_fwd_tc' in calls and 'nfk_chain_fwd' not in calls
    assert fm.chain_kernel.launches == launches + 1
    np.testing.assert_allclose(
        got.cpu().numpy(), fm.chain_reference(plan, x, p, BF16).cpu().numpy(),
        **TOL['bf16'])
    assert rel_norm(got, fm.chain_kernel_cuda_core(plan, x, p, BF16)) \
        <= TC_FWD_VS_CUDA_CORE_TOL
    assert torch.equal(got, fm.chain_kernel(plan, x, p, BF16))


# The K1-fwd calls the rule keeps on the CUDA-core kernel: (plan, compute
# dtype, launcher, plain version), as test_torch_emu.OFF_TC_FWD at card
# widths
OFF_TC_FWD = {
    'f32': (LVIS, None, fm.chain_kernel, fm.chain_reference),
    'stash': (LVIS, None, lambda *a: fm.chain_kernel_stash(*a)[0],
              fm.chain_reference_stash),
    'last_skip': ((LVIS[0], LVIS[1], LVIS[2], (2, 4)), None,
                  fm.chain_kernel_last_skip, fm.chain_reference),
    'skip_head': (OFF_TC_PLANS['skip_head'], BF16, fm.chain_kernel,
                  fm.chain_reference),
    'head9': (([(3, 4), (3, 2)], (128, 128, 9), ('relu', 'relu', None), ()),
              BF16, fm.chain_kernel, fm.chain_reference),
    'w704': (OFF_TC_PLANS['w704'], BF16, fm.chain_kernel, fm.chain_reference),
}


@pytest.mark.cuda
@pytest.mark.parametrize('case', sorted(OFF_TC_FWD))
def test_off_tc_fwd_keeps_the_cuda_core_kernel_on_card(case, cuda,
                                                       monkeypatch):
    """f32 on either route and K1w, a skip into the head, a head wider
    than 8 and hidden layers too wide for the block launch the CUDA-core
    K1-fwd, within TOL of the route's plain version."""
    args, cd, launch, plain = OFF_TC_FWD[case]
    plan, p, x, _ = card_case(args, 4099, 61, cuda)
    calls = recorded_calls(monkeypatch)
    got = launch(plan, x, p, cd)
    torch.cuda.synchronize()
    assert 'nfk_chain_fwd' in calls and 'nfk_chain_fwd_tc' not in calls
    np.testing.assert_allclose(got.cpu().numpy(),
                               plain(plan, x, p, cd).cpu().numpy(),
                               **TOL['bf16' if cd else 'f32'])


def stash_launches():
    return (fm.chain_kernel_stash.launches, fm.chain_kernel_stash.tc_launches,
            fm.chain_kernel_stash_bwd.launches,
            fm.chain_kernel_stash_bwd.tc_launches)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099, 70001])
@pytest.mark.parametrize('name', sorted(TC_PLANS))
def test_tc_stash_fwd_on_card(name, n, cuda, monkeypatch):
    """One K1r-fwd launch through the tensor-core entry, counted once
    (and once as a tensor-core launch): within TOL of the plain bf16 stash
    route, within TC_FWD_VS_CUDA_CORE_TOL of the CUDA-core kernel, its
    stash the CUDA-core kernel's bit for bit, both bit-identical across
    launches."""
    plan, p, x, _ = card_case(TC_PLANS[name], n, 62, cuda)
    calls = recorded_calls(monkeypatch)
    before = stash_launches()
    y, stash = fm.chain_kernel_stash(plan, x, p, BF16, with_stash=True)
    torch.cuda.synchronize()
    assert 'nfk_chain_stash_fwd_tc' in calls and 'nfk_chain_fwd' not in calls
    assert stash_launches() == (before[0] + 1, before[1] + 1) + before[2:]
    np.testing.assert_allclose(
        y.cpu().numpy(),
        fm.chain_reference_stash(plan, x, p, BF16).cpu().numpy(),
        **TOL['bf16'])
    y_core, stash_core = fm.chain_kernel_stash_cuda_core(plan, x, p, BF16,
                                                         with_stash=True)
    assert rel_norm(y, y_core) <= TC_FWD_VS_CUDA_CORE_TOL
    assert stash.dtype == BF16 and torch.equal(stash, stash_core)
    y2, stash2 = fm.chain_kernel_stash(plan, x, p, BF16, with_stash=True)
    assert torch.equal(y, y2) and torch.equal(stash, stash2)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099, 70001])
@pytest.mark.parametrize('name', sorted(TC_PLANS))
def test_tc_stash_bwd_on_card(name, n, cuda, monkeypatch):
    """One K1r-bwd launch with dW only through the tensor-core entry,
    counted once (and once as a tensor-core launch): dW/db within
    TC_VS_CUDA_CORE_TOL of the CUDA-core K1r-bwd's over the same stash,
    within TC_DW_TOL_BF16 of autograd of the plain bf16 stash route,
    bit-identical across launches."""
    plan, p, x, dy = card_case(TC_PLANS[name], n, 63, cuda)
    _, stash = fm.chain_kernel_stash_cuda_core(plan, x, p, BF16,
                                               with_stash=True)
    calls = recorded_calls(monkeypatch)
    before = stash_launches()
    got = leaves(fm.chain_kernel_stash_bwd(plan, x, dy, stash, p, BF16,
                                           needs_dx=False)[1])
    torch.cuda.synchronize()
    assert 'nfk_chain_stash_bwd_tc' in calls and 'nfk_chain_bwd' not in calls
    assert stash_launches() == before[:2] + (before[2] + 1, before[3] + 1)
    core = leaves(fm.chain_kernel_stash_bwd_cuda_core(
        plan, x, dy, stash, p, BF16, needs_dx=False)[1])
    assert worst(got, core) <= TC_VS_CUDA_CORE_TOL
    for g, w in zip(got, plain_dparams(plan, x, dy, p, BF16,
                                       fm.chain_reference_stash)):
        assert g.shape == w.shape and rel_norm(g, w) <= TC_DW_TOL_BF16
    again = leaves(fm.chain_kernel_stash_bwd(plan, x, dy, stash, p, BF16,
                                             needs_dx=False)[1])
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def with_last_skip(args):
    """A plan's arguments with a skip after its head added (K1w)."""
    parts, widths, acts, skip_at = args
    return parts, widths, acts, tuple(skip_at) + (len(widths) - 1,)


# TC_PLANS with a skip after the head too: each keeps its skip consumer
K1W_PLANS = {name: with_last_skip(args) for name, args in TC_PLANS.items()}


def last_skip_case(name, n, seed, device):
    """card_case on K1W_PLANS[name] with dy (n, out_dim), and the plan
    without the last skip (what K1 runs on the same layers)."""
    plan, p, x, _ = card_case(K1W_PLANS[name], n, seed, device)
    dy = torch.from_numpy(np.random.RandomState(seed + 3).uniform(
        -1, 1, (n, fm.out_dim(plan))).astype(np.float32)).to(device)
    return plan, p, x, dy, plan._replace(skip_at=plan.skip_at[:-1])


def last_skip_launches():
    return (fm.chain_kernel_last_skip.launches,
            fm.chain_kernel_last_skip.tc_launches,
            fm.chain_kernel_last_skip_bwd.launches,
            fm.chain_kernel_last_skip_bwd.tc_launches)


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099, 70001])
@pytest.mark.parametrize('name', sorted(K1W_PLANS))
def test_tc_last_skip_fwd_on_card(name, n, cuda, monkeypatch):
    """One K1w-fwd launch through the tensor-core entry, counted once
    (and once as a tensor-core launch): within TOL of the plain bf16
    version; its head column the tensor-core K1-fwd's on the plan without
    the last skip and its embedding columns the CUDA-core K1w-fwd's, bit
    for bit; within TC_FWD_VS_CUDA_CORE_TOL of the CUDA-core kernel;
    bit-identical across launches."""
    plan, p, x, _, k1_plan = last_skip_case(name, n, 64, cuda)
    calls = recorded_calls(monkeypatch)
    before = last_skip_launches()
    y = fm.chain_kernel_last_skip(plan, x, p, BF16)
    torch.cuda.synchronize()
    assert 'nfk_chain_last_skip_fwd_tc' in calls \
        and 'nfk_chain_fwd' not in calls
    assert last_skip_launches() == (before[0] + 1, before[1] + 1) + before[2:]
    np.testing.assert_allclose(
        y.cpu().numpy(), fm.chain_reference(plan, x, p, BF16).cpu().numpy(),
        **TOL['bf16'])
    no = plan.widths[-1]
    y_core = fm.chain_kernel_last_skip_cuda_core(plan, x, p, BF16)
    assert torch.equal(y[:, :no], fm.chain_kernel(k1_plan, x, p, BF16))
    assert torch.equal(y[:, no:], y_core[:, no:])
    assert rel_norm(y, y_core) <= TC_FWD_VS_CUDA_CORE_TOL
    assert torch.equal(y, fm.chain_kernel_last_skip(plan, x, p, BF16))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099, 70001])
@pytest.mark.parametrize('name', sorted(K1W_PLANS))
def test_tc_last_skip_bwd_on_card(name, n, cuda, monkeypatch):
    """K1w-bwd through the tensor-core entry with dx and dW, dW only and
    dx only, each counted once (and once as a tensor-core launch): dW/db
    the tensor-core K1-bwd's with dy's head column bit for bit, within
    TC_DW_TOL_BF16 of autograd of the plain bf16 version; dx within
    TC_VS_CUDA_CORE_TOL of the CUDA-core K1w-bwd's and TC_DW_TOL_BF16 of
    the plain version's; each mode's dx and dW/db the others' and
    bit-identical across launches."""
    plan, p, x, dy, k1_plan = last_skip_case(name, n, 65, cuda)
    flat = [t.clone().requires_grad_() for t in leaves(p)]
    xg = x.clone().requires_grad_()
    want = torch.autograd.grad(fm.chain_reference(
        plan, xg, list(zip(flat[0::2], flat[1::2])), BF16), [xg] + flat, dy)
    k1 = leaves(fm.chain_kernel_bwd(k1_plan, x, dy[:, :plan.widths[-1]]
                                    .contiguous(), p, BF16,
                                    needs_dx=False)[1])
    dx_core = fm.chain_kernel_last_skip_bwd_cuda_core(plan, x, dy, p, BF16,
                                                      needs_dw=False)[0]
    calls = recorded_calls(monkeypatch)
    got = {}
    for flags in ((True, True), (False, True), (True, False)):
        before = last_skip_launches()
        del calls[:]
        got[flags] = fm.chain_kernel_last_skip_bwd(plan, x, dy, p, BF16,
                                                   *flags)
        torch.cuda.synchronize()
        assert 'nfk_chain_last_skip_bwd_tc' in calls \
            and 'nfk_chain_bwd' not in calls
        assert last_skip_launches() == before[:2] + (before[2] + 1,
                                                     before[3] + 1)
    dx, dparams = got[(True, True)]
    assert all(torch.equal(a, b) for a, b in zip(leaves(dparams), k1))
    for g, w in zip(leaves(dparams), want[1:]):
        assert g.shape == w.shape and rel_norm(g, w) <= TC_DW_TOL_BF16
    assert rel_norm(dx, dx_core) <= TC_VS_CUDA_CORE_TOL
    assert rel_norm(dx, want[0]) <= TC_DW_TOL_BF16
    assert got[(False, True)][0] is None and got[(True, False)][1] is None
    assert torch.equal(got[(True, False)][0], dx)
    assert all(torch.equal(a, b) for a, b in zip(
        leaves(got[(False, True)][1]), leaves(dparams)))
    dx2, again = fm.chain_kernel_last_skip_bwd(plan, x, dy, p, BF16)
    assert torch.equal(dx2, dx)
    assert all(torch.equal(a, b) for a, b in zip(leaves(again),
                                                 leaves(dparams)))


def card_readings(seeds, sizes=(1, 50, 4099)):
    """Per plan of the card tests (PLANS' widths 16 and 32, TC_PLANS) and
    size, over ``seeds``: the worst dW/db leaf of bf16 K1-bwd with dW only
    (the tensor cores) against autograd of the plain bf16 version and
    against the CUDA-core bf16 kernel, and the least reading of the f32
    kernel against the plain bf16 version; the worst output of bf16 K1-fwd
    on the tensor cores against the CUDA-core bf16 kernel and the least
    reading of the f32 kernel (the control) against it; on the stash route,
    the worst dW/db leaf of bf16 K1r-bwd with dW only on the tensor cores
    against autograd of the plain bf16 stash route and against the
    CUDA-core bf16 K1r-bwd, the worst output of bf16 K1r-fwd on the tensor
    cores against the CUDA-core one, and whether their stashes are
    equal; with a skip after the head too (K1W_PLANS' and PLANS' plans),
    bf16 K1w-bwd's dx on the tensor cores and the f32 kernel's (the
    control) against the CUDA-core bf16 K1w-bwd's, and whether K1w's head
    and dW/db are the tensor-core K1's and its embedding columns the
    CUDA-core K1w's, bit for bit."""
    out = []
    device = torch.device('cuda')
    for name, args in sorted(dict(PLANS, **TC_PLANS).items()):
        for n in sizes:
            r = {'chain': name, 'n': n, 'tc_vs_plain': 0.0,
                 'tc_vs_cuda_core': 0.0, 'f32_kernel_vs_plain': np.inf,
                 'tc_fwd_vs_cuda_core': 0.0, 'f32_fwd_vs_cuda_core': np.inf,
                 'stash_tc_vs_plain': 0.0, 'stash_tc_vs_cuda_core': 0.0,
                 'stash_tc_fwd_vs_cuda_core': 0.0, 'stash_equal': True,
                 'last_skip_dx_vs_cuda_core': 0.0,
                 'last_skip_f32_dx_vs_cuda_core': np.inf,
                 'last_skip_same_as_k1_and_cuda_core': True}
            for seed in seeds:
                plan, p, x, dy = card_case(args, n, seed, device)
                want = plain_dparams(plan, x, dy, p, BF16)
                got = leaves(fm.chain_kernel_bwd(plan, x, dy, p, BF16,
                                                 needs_dx=False)[1])
                core = leaves(fm.chain_kernel_bwd(plan, x, dy, p, BF16)[1])
                f32 = leaves(fm.chain_kernel_bwd(plan, x, dy, p, None)[1])
                r['tc_vs_plain'] = max(r['tc_vs_plain'], worst(got, want))
                r['tc_vs_cuda_core'] = max(r['tc_vs_cuda_core'],
                                           worst(got, core))
                r['f32_kernel_vs_plain'] = min(r['f32_kernel_vs_plain'],
                                               worst(f32, want))
                y_core = fm.chain_kernel_cuda_core(plan, x, p, BF16)
                r['tc_fwd_vs_cuda_core'] = max(
                    r['tc_fwd_vs_cuda_core'],
                    rel_norm(fm.chain_kernel(plan, x, p, BF16), y_core))
                r['f32_fwd_vs_cuda_core'] = min(
                    r['f32_fwd_vs_cuda_core'],
                    rel_norm(fm.chain_kernel_cuda_core(plan, x, p, None),
                             y_core))
                y, stash = fm.chain_kernel_stash(plan, x, p, BF16,
                                                 with_stash=True)
                y_core, stash_core = fm.chain_kernel_stash_cuda_core(
                    plan, x, p, BF16, with_stash=True)
                got = leaves(fm.chain_kernel_stash_bwd(
                    plan, x, dy, stash, p, BF16, needs_dx=False)[1])
                core = leaves(fm.chain_kernel_stash_bwd_cuda_core(
                    plan, x, dy, stash, p, BF16, needs_dx=False)[1])
                for key, val in (
                        ('stash_tc_vs_plain', worst(got, plain_dparams(
                            plan, x, dy, p, BF16, fm.chain_reference_stash))),
                        ('stash_tc_vs_cuda_core', worst(got, core)),
                        ('stash_tc_fwd_vs_cuda_core', rel_norm(y, y_core))):
                    r[key] = max(r[key], val)
                r['stash_equal'] &= torch.equal(stash, stash_core)
                lplan = fm.make_plan(*with_last_skip(args))
                ldy = torch.from_numpy(np.random.RandomState(seed + 3).uniform(
                    -1, 1, (n, fm.out_dim(lplan))).astype(np.float32)).to(device)
                no = plan.widths[-1]
                y = fm.chain_kernel_last_skip(lplan, x, p, BF16)
                dx, dw = fm.chain_kernel_last_skip_bwd(lplan, x, ldy, p, BF16)
                core = fm.chain_kernel_last_skip_bwd_cuda_core(
                    lplan, x, ldy, p, BF16, needs_dw=False)[0]
                dx32 = fm.chain_kernel_last_skip_bwd_cuda_core(
                    lplan, x, ldy, p, None, needs_dw=False)[0]
                k1 = leaves(fm.chain_kernel_bwd(
                    plan, x, ldy[:, :no].contiguous(), p, BF16,
                    needs_dx=False)[1])
                r['last_skip_dx_vs_cuda_core'] = max(
                    r['last_skip_dx_vs_cuda_core'], rel_norm(dx, core))
                r['last_skip_f32_dx_vs_cuda_core'] = min(
                    r['last_skip_f32_dx_vs_cuda_core'], rel_norm(dx32, core))
                r['last_skip_same_as_k1_and_cuda_core'] &= torch.equal(
                    y[:, :no], fm.chain_kernel(plan, x, p, BF16)) \
                    and torch.equal(y[:, no:], fm.chain_kernel_last_skip_cuda_core(
                        lplan, x, p, BF16)[:, no:]) \
                    and all(torch.equal(a, b) for a, b in zip(leaves(dw), k1))
            out.append(r)
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--seeds', default='40,41,42,43')
    args = parser.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    for r in card_readings([int(s) for s in args.seeds.split(',')]):
        print(json.dumps(r))


if __name__ == '__main__':
    main()
