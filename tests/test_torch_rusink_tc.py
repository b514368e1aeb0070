"""bf16 K2-fwd and K2-bwd on the tensor cores, on a card: the frozen BRDF
chain on Rusinkiewicz coordinates (``csrc/fused_rusink.cu``'s
``rusink_chain_fwd_tc_kernel`` and ``rusink_chain_bwd_tc_kernel``), which
the joint step and joint serving run.

The tests carry the ``cuda`` marker and skip without a card (the kernels
have no CPU mode; ``test_torch_emu_rusink`` holds the same sources on the
CPU through the g++ emulation). At the BRDF chain's width (128 x 4, the
embedding concatenated after layer 2, a 1-wide softplus head) and at
``test_torch_chain``'s width 16, from 1 to 4,099 rows and at the smoke's
limit seeds: both kernels against the CUDA-core kernels they replace and
the plain version (autograd of it for the backward), bit-identical across
launches; under ``apply_rusink_chain`` with autograd, the backward reads
the transposed weights the forward packed; f32 keeps the CUDA-core
kernels.

  python -m tests.test_torch_rusink_tc [--seeds 40,41,42,43]

prints, on a card, the readings behind the bounds here.
"""

import argparse
import json

import numpy as np
import pytest
import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_rusink as fr
from tests.test_torch_chain import (
    RUSINK_PLAN, assert_rusink_close, both, rel_norm, rusink_inputs)
from tests.test_torch_chain_tc import recorded_calls

# The BRDF chain at the shipped brdf.ini widths
BRDF = ([(3, 0), (3, 2)], (128,) * 4 + (1,), ('relu',) * 4 + ('softplus',),
        (2,))
RUSINK_TC_PLANS = {'w16': RUSINK_PLAN, 'brdf': BRDF}
BF16 = torch.bfloat16
# chip_smoke.py --limit_seeds k2 11,12,13,14
SMOKE_SEEDS = (11, 12, 13, 14)


def rusink_rows(n, seed):
    """z, ldir, vdir (numpy f32) of ``n`` rows and how many of the first
    rows a gradient is held on: test_torch_chain.rusink_inputs' rows (two
    next to phi_d's wrap first, three with ldir == vdir last, where the
    safe-acos gradient is ~1e3 and ill-conditioned) for n >= 5, held on
    all but the last 3; below that its first n rows, held on all."""
    a, b = rusink_inputs(n=n if n >= 5 else 8, seed=seed)
    a, b = a[:n], b[:n]
    z = np.random.RandomState(seed).randn(n, 3).astype(np.float32)
    return (z, a, b), (n - 3 if n >= 5 else n)


def rusink_tc_case(name, n, seed, device):
    """(plan, params, [z, ldir, vdir], dy, rows held) on ``device``."""
    _, _, plan, p = both(RUSINK_TC_PLANS[name], seed=seed)
    ins, held = rusink_rows(n, seed + 1)
    dy = np.random.RandomState(seed + 2).uniform(-1, 1, (n, 1)).astype(
        np.float32)
    return (plan, [(w.to(device), b.to(device)) for w, b in p],
            [torch.from_numpy(v).to(device) for v in ins],
            torch.from_numpy(dy).to(device), held)


def plain_grads(plan, ins, dy, p, td):
    """Autograd of the plain version: (dz, dldir, dvdir)."""
    args = [t.clone().requires_grad_() for t in ins]
    return torch.autograd.grad(fr.reference(plan, *args, p, td), args, dy)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


# The tensor-core kernels round where the CUDA-core ones do (posts and
# d_pre at bf16, d_h and the embedding's cotangent in f32) and sum in
# another order; on the card a value next to a bf16 rounding boundary
# rounds the other way. Relative norm over all rows of the output, and of
# each cotangent over the rows held. Readings (python -m
# tests.test_torch_rusink_tc, seeds 40-43, both plans at 1, 64 and 4,099
# rows; NVIDIA H100 80GB HBM3, 700.00 W): the forward <= 3.8e-5 from the
# CUDA-core bf16 kernel, the f32 kernel (the control) >= 1.5e-4; the
# backward <= 0.0025, the f32 kernel >= 0.0041.
TC_FWD_VS_CUDA_CORE_TOL = 1e-4
TC_BWD_VS_CUDA_CORE_TOL = 0.01
# Against autograd of the plain bf16 version, which rounds every cotangent
# at each cast: dx sums 2^j (cos g_sin - sin g_cos) over the octaves, and
# where that cancels the two roundings part in single elements (3 of
# 12,288 beyond GRAD_TOL at 4,099 rows), so the cotangents are held by
# relative norm, as the chain's dx (test_torch_chain DW_TOL). Readings
# (same runs): up to 0.28 (width 16, 1 row; 0.089 at the BRDF chain's
# width), the CUDA-core kernel within 0.0025 of it. The bound catches a wrong
# layer or layout (~1); the rounding policy is held by
# test_torch_emu_rusink (against the Pallas kernel) and chip_smoke.py (at
# the joint step's 524,288 rows, NORM_TOL_BF16).
TC_BWD_VS_PLAIN_TOL = 0.35


@pytest.mark.cuda
@pytest.mark.parametrize('name,n,seed', [
    (name, n, 60) for name in sorted(RUSINK_TC_PLANS)
    for n in (1, 63, 64, 65, 4099)] + [('brdf', 4099, s) for s in SMOKE_SEEDS])
def test_tc_rusink_on_card(name, n, seed, cuda, monkeypatch):
    """One K2-fwd and one K2-bwd launch through the tensor-core entries,
    each counted once: the output within TOL of the plain bf16 version and
    within TC_FWD_VS_CUDA_CORE_TOL of the CUDA-core kernel; each cotangent
    finite, within TC_BWD_VS_PLAIN_TOL of autograd of the plain bf16
    version and within TC_BWD_VS_CUDA_CORE_TOL of the CUDA-core kernel
    over the rows held; both bit-identical across launches."""
    plan, p, ins, dy, held = rusink_tc_case(name, n, seed, cuda)
    calls = recorded_calls(monkeypatch)
    launches = (fr.rusink_kernel.tc_launches, fr.rusink_kernel_bwd.tc_launches)
    y = fr.rusink_kernel(plan, *ins, p, BF16)
    got = fr.rusink_kernel_bwd(plan, *ins, dy, p, BF16)
    torch.cuda.synchronize()
    assert 'nfk_rusink_chain_fwd_tc' in calls \
        and 'nfk_rusink_chain_bwd_tc' in calls
    assert 'nfk_rusink_chain_fwd' not in calls \
        and 'nfk_rusink_chain_bwd' not in calls
    assert (fr.rusink_kernel.tc_launches, fr.rusink_kernel_bwd.tc_launches) \
        == (launches[0] + 1, launches[1] + 1)
    assert_rusink_close(y.cpu().numpy(), fr.reference(
        plan, *ins, p, BF16).cpu().numpy(), 'bf16')
    assert rel_norm(y, fr.rusink_kernel_cuda_core(plan, *ins, p, BF16)) \
        <= TC_FWD_VS_CUDA_CORE_TOL
    core = fr.rusink_kernel_bwd_cuda_core(plan, *ins, dy, p, BF16)
    for g, c, w in zip(got, core, plain_grads(plan, ins, dy, p, BF16)):
        assert torch.isfinite(g).all()
        assert rel_norm(g[:held], w[:held]) <= TC_BWD_VS_PLAIN_TOL
        assert rel_norm(g[:held], c[:held]) <= TC_BWD_VS_CUDA_CORE_TOL
    assert torch.equal(y, fr.rusink_kernel(plan, *ins, p, BF16))
    assert all(torch.equal(a, b) for a, b in zip(
        got, fr.rusink_kernel_bwd(plan, *ins, dy, p, BF16)))


@pytest.mark.cuda
def test_apply_rusink_chain_hands_packed_weights_to_backward_on_card(
        cuda, monkeypatch):
    """apply_rusink_chain under autograd in bf16: one tensor-core launch
    each way, the backward over the transposed weights the forward packed
    (ctx.wt, packed once a step), the cotangents equal to a K2-bwd launch
    that packs its own, zero weight cotangents."""
    plan, p, ins, dy, held = rusink_tc_case('brdf', 4099, 61, cuda)
    packs, pack = [], fm.transposed_weights

    def counted(*args):
        packs.append(pack(*args))
        return packs[-1]
    monkeypatch.setattr(fm, 'transposed_weights', counted)
    launches = (fr.rusink_kernel.tc_launches, fr.rusink_kernel_bwd.tc_launches)
    flat = [t.clone().requires_grad_() for pair in p for t in pair]
    args = [t.clone().requires_grad_() for t in ins]
    y = fr.apply_rusink_chain(plan, *args, list(zip(flat[0::2], flat[1::2])),
                              compute_dtype=BF16)
    wt = y.grad_fn.wt
    grads = torch.autograd.grad(y, args + flat, dy)
    torch.cuda.synchronize()
    assert len(packs) == 1 and packs[0] is wt
    kplan = fm.mma_plan(plan)
    w_flat, _ = fm.pack_params(
        kplan, fm.pad_params(plan, p) if kplan != plan else p, BF16)
    assert torch.equal(wt, pack(kplan, w_flat))
    assert (fr.rusink_kernel.tc_launches, fr.rusink_kernel_bwd.tc_launches) \
        == (launches[0] + 1, launches[1] + 1)
    want = fr.rusink_kernel_bwd(plan, *ins, dy, p, BF16)
    assert all(torch.equal(g, w) for g, w in zip(grads[:3], want))
    assert not any(g.any() for g in grads[3:])


@pytest.mark.cuda
def test_f32_rusink_keeps_the_cuda_core_kernels_on_card(cuda, monkeypatch):
    """f32 K2-fwd and K2-bwd launch the CUDA-core kernels, bit-identical to
    the CUDA-core wrappers' launches."""
    plan, p, ins, dy, _ = rusink_tc_case('brdf', 4099, 62, cuda)
    calls = recorded_calls(monkeypatch)
    y = fr.rusink_kernel(plan, *ins, p, None)
    got = fr.rusink_kernel_bwd(plan, *ins, dy, p, None)
    torch.cuda.synchronize()
    assert calls == ['nfk_rusink_chain_fwd', 'nfk_rusink_chain_bwd']
    assert torch.equal(y, fr.rusink_kernel_cuda_core(plan, *ins, p, None))
    assert all(torch.equal(a, b) for a, b in zip(
        got, fr.rusink_kernel_bwd_cuda_core(plan, *ins, dy, p, None)))


def card_readings(seeds, sizes=(1, 64, 4099)):
    """Per plan and size, over ``seeds``: the tensor-core kernels against
    the CUDA-core bf16 kernels (the output, and the worst cotangent over
    the rows held, relative norm) beside the f32 CUDA-core kernel against
    the same (the control), and the tensor-core cotangents against
    autograd of the plain bf16 version."""
    out = []
    device = torch.device('cuda')
    for name in sorted(RUSINK_TC_PLANS):
        for n in sizes:
            worst = {'tc_fwd_vs_cuda_core': 0.0, 'tc_bwd_vs_cuda_core': 0.0,
                     'tc_bwd_vs_plain': 0.0}
            least = {'f32_fwd_vs_cuda_core': np.inf,
                     'f32_bwd_vs_cuda_core': np.inf}
            for seed in seeds:
                plan, p, ins, dy, held = rusink_tc_case(name, n, seed, device)

                def fwd(cd):
                    return fr.rusink_kernel_cuda_core(plan, *ins, p, cd)

                def bwd(cd):
                    return fr.rusink_kernel_bwd_cuda_core(plan, *ins, dy, p,
                                                          cd)

                def cotangents(a, b):
                    return max(rel_norm(u[:held], v[:held])
                               for u, v in zip(a, b))
                y_core, g_core = fwd(BF16), bwd(BF16)
                got = fr.rusink_kernel_bwd(plan, *ins, dy, p, BF16)
                for key, val in (
                        ('tc_fwd_vs_cuda_core', rel_norm(fr.rusink_kernel(
                            plan, *ins, p, BF16), y_core)),
                        ('tc_bwd_vs_cuda_core', cotangents(got, g_core)),
                        ('tc_bwd_vs_plain', cotangents(got, plain_grads(
                            plan, ins, dy, p, BF16)))):
                    worst[key] = max(worst[key], val)
                for key, val in (
                        ('f32_fwd_vs_cuda_core', rel_norm(fwd(None), y_core)),
                        ('f32_bwd_vs_cuda_core', cotangents(bwd(None),
                                                            g_core))):
                    least[key] = min(least[key], val)
            out.append(dict({'chain': name, 'n': n}, **worst, **least))
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
