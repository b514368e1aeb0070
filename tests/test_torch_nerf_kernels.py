"""Kernels K3-fwd and K3-bwd on the card against the plain version.

These tests carry the ``cuda`` marker and skip without a card; on one:

  python -m pytest tests/test_torch_nerf_kernels.py -m cuda -q

Widths 32 (depth 4), nerf.ini's 256 (depth 8, skip after layer 4) and 272
(two column passes a product in bf16 K3-bwd), f32 and bf16, 1 to 5,000
rows. f32 outputs within 1e-5, dW/db per-leaf within 1e-4 of the norm
(summation order); bf16 outputs within 1e-2 (the kernel also rounds the
bottleneck and rgb layer 0's operands) and dW/db within NERF_DW_TOL.
K3-bwd's dW is bit-identical across launches. bf16 K3-fwd on the tensor
cores at those widths and off the mma step (24), against the plain
version and the CUDA-core kernel. The bf16 backward's parts alone: the
tensor-core building block (mma.sync fragments, loaders, cp.async
pipeline) and the dW pass, each against the float64 product of the same
bf16 values.
"""

import numpy as np
import pytest
import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_nerf as fn
from tests.test_torch_chain import DTYPES, TOL, rel_norm
from tests.test_torch_chain_tc import recorded_calls
from tests.test_torch_emu import (
    NERF_FWD_PLANS, NERF_PLAN_W24, NERF_PLANS, TC_SHAPES, bf16_values,
    dw_scratch, nerf_case)
from tests.test_torch_nerf import (
    field_inputs, field_params, plain_field, torch_params)


# Per-leaf relative norm of dW/db against the plain version. In bf16 the
# plain version's autograd rounds every cotangent at each cast and K3-bwd
# only d_pre, so at these sizes they part by up to 0.175 (emulation, widths
# 32 and 256, 1 to 500 rows, 3 seeds; 0.103 on an H100 at 5,000 rows), and
# the f32 kernel reads as close: the bound catches a wrong layer or layout
# (~1), not the rounding policy. That is held by test_torch_emu against the
# TPU kernel and by chip_smoke.py at a train step's shapes.
NERF_DW_TOL = {'f32': 1e-4, 'bf16': 0.25}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 70, 5000])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(NERF_PLANS))
def test_nerf_kernels_match_plain_on_card(name, mode, n, cuda):
    """apply_nerf under autograd launches K3-fwd once and K3-bwd once."""
    nplan, p, ins = nerf_case(name, n, seed=50)
    pts, views, drgb, dsig = (a.to(cuda) for a in ins)
    params = torch_params(p, cuda)
    td = DTYPES[mode][1]
    rgb, sigma, want = plain_field(nplan, pts, views, drgb, dsig, params, td)
    flat = [x.clone().requires_grad_() for x in fn.flatten(params)]
    launches = (fn.nerf_kernel.launches, fn.nerf_kernel_bwd.launches)
    got_rgb, got_sigma = fn.apply_nerf(nplan, pts, views,
                                       fn.unflatten(nplan, flat),
                                       compute_dtype=td)
    got = torch.autograd.grad([got_rgb, got_sigma], flat, [drgb, dsig])
    torch.cuda.synchronize()
    assert (fn.nerf_kernel.launches, fn.nerf_kernel_bwd.launches) == (
        launches[0] + 1, launches[1] + 1)
    for g, w in ((got_rgb, rgb), (got_sigma, sigma)):
        np.testing.assert_allclose(g.detach().cpu().numpy(),
                                   w.cpu().numpy(), **TOL[mode])
    for g, w in zip(got, want):
        assert rel_norm(g, w) <= NERF_DW_TOL[mode]
    again = fn.flatten(fn.nerf_kernel_bwd(nplan, pts, views, drgb, dsig,
                                          params, td))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [70, 5000])
def test_bf16_bwd_pads_widths_off_the_mma_step_on_card(n, cuda):
    """bf16 K3-bwd at trunk width 24 and rgb hidden width 8, run on the
    tensor cores at widths 32 and 16 over zero-padded weights."""
    nplan = fn.make_nerf_plan(**NERF_PLAN_W24)
    params = torch_params(field_params(nplan, 52), cuda)
    pts, views, drgb, dsig = (torch.from_numpy(a).to(cuda)
                              for a in field_inputs(n, 53))
    want = plain_field(nplan, pts, views, drgb, dsig, params,
                       torch.bfloat16)[2]
    got = fn.flatten(fn.nerf_kernel_bwd(nplan, pts, views, drgb, dsig,
                                        params, torch.bfloat16))
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert rel_norm(g, w) <= NERF_DW_TOL['bf16']
    again = fn.flatten(fn.nerf_kernel_bwd(nplan, pts, views, drgb, dsig,
                                          params, torch.bfloat16))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# The tensor-core K3-fwd against the CUDA-core bf16 one, relative norm of
# [rgb | sigma]: the same rounding points, another order of sums, so on the
# card a post next to a bf16 rounding boundary may round the other way.
# Readings (chip_smoke.py's K3-fwd row, nerf.ini's trained field at
# 196,608 rows, and K1 on the 256-wide no-views chain; NVIDIA H100 80GB
# HBM3, 700.00 W): the tensor-core kernel 3.2e-4 from the CUDA-core bf16
# kernel in both, the f32 kernel (the control) 3.3e-3 and 3.9e-3.
NERF_TC_FWD_VS_CUDA_CORE_TOL = 2e-3


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 70, 5000])
@pytest.mark.parametrize('name', sorted(NERF_FWD_PLANS))
def test_tc_nerf_fwd_on_card(name, n, cuda, monkeypatch):
    """bf16 K3-fwd through the tensor-core entry, counted once: within
    TOL of the plain bf16 version, within NERF_TC_FWD_VS_CUDA_CORE_TOL of
    the CUDA-core kernel, bit-identical across launches."""
    nplan = fn.make_nerf_plan(**NERF_FWD_PLANS[name])
    params = torch_params(field_params(nplan, 54), cuda)
    pts, views = (torch.from_numpy(a).to(cuda)
                  for a in field_inputs(n, 55)[:2])
    calls = recorded_calls(monkeypatch)
    launches = fn.nerf_kernel.launches

    def fwd(f):
        return torch.cat(f(nplan, pts, views, params, torch.bfloat16), dim=1)
    got = fwd(fn.nerf_kernel)
    torch.cuda.synchronize()
    assert 'nfk_nerf_fwd_tc' in calls and 'nfk_nerf_fwd' not in calls
    assert fn.nerf_kernel.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(),
                               fwd(fn.nerf_reference).cpu().numpy(),
                               **TOL['bf16'])
    assert rel_norm(got, fwd(fn.nerf_kernel_cuda_core)) \
        <= NERF_TC_FWD_VS_CUDA_CORE_TOL
    assert torch.equal(got, fwd(fn.nerf_kernel))


@pytest.mark.cuda
def test_nerf_kernel_rejects_cpu_and_bad_params(cuda):
    nplan, p, ins = nerf_case('w32', 8, seed=51)
    params = torch_params(p, cuda)
    with pytest.raises(ValueError, match='CUDA float32'):
        fn.nerf_kernel(nplan, ins[0], ins[1].to(cuda), params)
    with pytest.raises(ValueError, match='do not fit'):
        fn.nerf_kernel(fn.make_nerf_plan(**dict(NERF_PLANS['w32'],
                                                width=16)),
                       ins[0].to(cuda), ins[1].to(cuda), params)


# bf16 products accumulated in f32 on the tensor cores against float64:
# the summation order and the tensor cores' f32 adds only (the emulation
# reads <= 1e-5 at these sizes).
TC_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize('m,n,k', TC_SHAPES)
def test_tc_matmul_matches_float64_on_card(m, n, k, cuda):
    """The hardware's mma.sync lane mapping is the one the emulation
    assumes."""
    rng = np.random.RandomState(m + n + k)
    a, b = (bf16_values(rng, s).to(cuda) for s in ((m, k), (n, k)))
    got = fn.tc_matmul(a, b).double()
    np.testing.assert_allclose(got.cpu().numpy(),
                               fn.tc_matmul_reference(a, b).cpu().numpy(),
                               **TC_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize('name,n', [('w32', 1), ('w32', 130), ('w256', 130),
                                    ('w256', 5000)])
def test_dw_pass_matches_float64_on_card(name, n, cuda):
    nplan = fn.make_nerf_plan(**NERF_PLANS[name])
    tab, tile = fn.dw_table(nplan, cuda)
    scratch = dw_scratch(tab, n, seed=n).to(cuda)
    got = fm.dw_pass(tab, tile, scratch, n)
    want = fm.dw_reference(tab, scratch, n)
    np.testing.assert_allclose(got.double().cpu().numpy(), want.cpu().numpy(),
                               rtol=TC_TOL['rtol'],
                               atol=TC_TOL['atol'] * np.sqrt(n))
    assert torch.equal(got, fm.dw_pass(tab, tile, scratch, n))
