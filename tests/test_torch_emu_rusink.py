"""bf16 K2-fwd and K2-bwd on the tensor cores (``csrc/fused_rusink.cu``'s
``rusink_chain_fwd_tc_kernel`` and ``rusink_chain_bwd_tc_kernel``), run on
the CPU through the g++ emulation of the CUDA sources
(``test_torch_emu.emulated_library``) against the plain version, the
emulated CUDA-core K2 kernels and the JAX Pallas kernels
(``nerfactor_tpu/ops/pallas_rusink.py``) in interpret mode, at
``test_torch_chain``'s width 16 and the BRDF chain's 128; the rule that
sends a K2 launch to them; and under autograd, the transposed weights the
forward hands to the backward.

  JAX_PLATFORMS=cpu python -m tests.test_torch_emu_rusink

prints the readings behind the bounds here.
"""

import argparse
import json
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu.ops import pallas_rusink as pr
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_rusink as fr
from tests.test_torch_chain import (
    GRAD_TOL, assert_rusink_close, both, rel_norm)
from tests.test_torch_emu import CALLS, PALLAS_TOL_BF16, emulated_library
from tests.test_torch_rusink_tc import (
    BRDF, RUSINK_TC_PLANS, plain_grads, rusink_rows, rusink_tc_case)

CPU = torch.device('cpu')
BF16 = torch.bfloat16
SIZES = (1, 63, 64, 65, 130)


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    with emulated_library(str(tmp_path_factory.mktemp('emu'))):
        yield


def launched(run):
    """``run()``'s output and the library entries it called."""
    del CALLS[:]
    out = run()
    return out, list(CALLS)


def tc_fwd(plan, ins, p):
    y, calls = launched(lambda: fr.rusink_kernel(plan, *ins, p, BF16))
    assert 'nfk_rusink_chain_fwd_tc' in calls \
        and 'nfk_rusink_chain_fwd' not in calls
    return y


def tc_bwd(plan, ins, dy, p):
    g, calls = launched(lambda: fr.rusink_kernel_bwd(plan, *ins, dy, p, BF16))
    assert 'nfk_rusink_chain_bwd_tc' in calls \
        and 'nfk_rusink_chain_bwd' not in calls
    return g


def worst(got, want, held):
    """The worst of the cotangents' relative norms over the rows held."""
    return max(rel_norm(g[:held], w[:held]) for g, w in zip(got, want))


@pytest.mark.parametrize('n', SIZES)
@pytest.mark.parametrize('name', sorted(RUSINK_TC_PLANS))
def test_emulated_tc_rusink_matches_plain(name, n, emulated):
    """The tensor-core K2-fwd within TOL of the plain bf16 version (the
    ldir == vdir rows as test_torch_chain holds them); each K2-bwd
    cotangent within GRAD_TOL of autograd of it over the rows held, and
    finite on every row. 64-row tiles: one partial, one whole, one and a
    row, two and two rows."""
    plan, p, ins, dy, held = rusink_tc_case(name, n, 30, CPU)
    assert_rusink_close(tc_fwd(plan, ins, p).numpy(),
                        fr.reference(plan, *ins, p, BF16).numpy(), 'bf16')
    got = tc_bwd(plan, ins, dy, p)
    for g, w in zip(got, plain_grads(plan, ins, dy, p, BF16)):
        assert g.shape == w.shape and torch.isfinite(g).all()
        np.testing.assert_allclose(g[:held].numpy(), w[:held].numpy(),
                                   **GRAD_TOL['bf16'])


# The tensor-core kernels against the emulated CUDA-core ones, which round
# at the same places. The emulated mma sums its products in K order with
# fmaf, as the CUDA-core kernels' loops do, so only head_sums' four
# partial sums move the forward's head; the backward's d_pre, rounded at
# bf16 from there, come out equal. Readings (python -m
# tests.test_torch_emu_rusink, both plans at 1-130 rows, seeds 30, 130,
# 230): the forward <= 3.7e-8, the backward 0 (bit for bit) on the rows
# held. On the card, mma.sync's order of sums moves both (PERF.md, and
# the card's bounds in test_torch_rusink_tc).
TC_VS_CUDA_CORE_FWD_TOL = 1e-5
TC_VS_CUDA_CORE_BWD_TOL = 1e-6


@pytest.mark.parametrize('n', (64, 130))
@pytest.mark.parametrize('name', sorted(RUSINK_TC_PLANS))
def test_emulated_tc_rusink_matches_cuda_core(name, n, emulated):
    plan, p, ins, dy, held = rusink_tc_case(name, n, 31, CPU)
    assert rel_norm(tc_fwd(plan, ins, p), fr.rusink_kernel_cuda_core(
        plan, *ins, p, BF16)) <= TC_VS_CUDA_CORE_FWD_TOL
    assert worst(tc_bwd(plan, ins, dy, p), fr.rusink_kernel_bwd_cuda_core(
        plan, *ins, dy, p, BF16), held) <= TC_VS_CUDA_CORE_BWD_TOL


def pallas_rusink_grads(name, n, seed, compute_dtype=jnp.bfloat16):
    """(dz, dldir, dvdir) of the JAX Pallas K2 kernels in interpret mode on
    rusink_tc_case's inputs."""
    jplan, jp, _, _ = both(RUSINK_TC_PLANS[name], seed=seed)
    ins, _ = rusink_rows(n, seed + 1)
    dy = np.random.RandomState(seed + 2).uniform(-1, 1, (n, 1)).astype(
        np.float32)
    pm.INTERPRET = True
    try:
        grads = jax.grad(lambda *a: jnp.sum(pr.apply_rusink_chain(
            jplan, *a, jp, compute_dtype=compute_dtype) * dy),
            argnums=(0, 1, 2))(*(jnp.asarray(v) for v in ins))
    finally:
        pm.INTERPRET = False
    return [torch.from_numpy(np.array(g)) for g in grads]


# The Pallas kernel rounds where the tensor-core K2-bwd does (d_h and the
# embedding's cotangent in f32, d_pre in bf16), where the plain version
# rounds every cotangent at each cast. Readings (python -m
# tests.test_torch_emu_rusink, pallas_readings: both plans at 65 and 130
# rows, seeds 30, 130, 230), worst cotangent over the rows held: the
# tensor-core kernel <= 0.0066; the f32 kernel (a kernel that computed the
# f32 cotangent) >= 0.033 at the BRDF chain's width and >= 0.025 at width
# 16 at 130 rows, but 0.0076 at width 16 at 65 rows, where the bound does
# not part the two.
@pytest.mark.parametrize('name', sorted(RUSINK_TC_PLANS))
def test_emulated_tc_rusink_matches_interpreted_pallas_kernel(name, emulated):
    plan, p, ins, dy, held = rusink_tc_case(name, 130, 30, CPU)
    assert worst(tc_bwd(plan, ins, dy, p), pallas_rusink_grads(name, 130, 30),
                 held) <= PALLAS_TOL_BF16


@pytest.mark.parametrize('name', sorted(RUSINK_TC_PLANS))
def test_emulated_tc_rusink_bwd_is_bit_identical_across_launches(name,
                                                                 emulated):
    plan, p, ins, dy, _ = rusink_tc_case(name, 130, 32, CPU)
    a, b = tc_bwd(plan, ins, dy, p), tc_bwd(plan, ins, dy, p)
    assert all(torch.equal(u, v) for u, v in zip(a, b))


def test_rusink_on_tensor_cores_rule(emulated):
    """bf16 takes the tensor cores on the BRDF chain, at width 16 and at
    width 24 (padded to 32); f32, a non-ReLU hidden act, a skip into the
    head, a head wider than 8 and hidden layers too wide for the block
    (640; 512 fits) keep the CUDA-core kernels."""
    plan = fm.make_plan(*BRDF)

    def rule(pl, cd):
        return fr.rusink_on_tensor_cores(pl, cd, CPU)
    assert rule(plan, BF16)
    assert rule(fm.make_plan(*RUSINK_TC_PLANS['w16']), BF16)
    assert rule(plan._replace(widths=(24,) * 4 + (1,)), BF16)
    assert not rule(plan, None)
    assert not rule(plan, torch.float32)
    for act in ('sigmoid', 'softplus', None):
        assert not rule(plan._replace(acts=('relu', act, 'relu', 'relu',
                                            'softplus')), BF16)
    assert not rule(plan._replace(skip_at=(3,)), BF16)
    for head, ok in ((8, True), (9, False)):
        assert rule(plan._replace(widths=plan.widths[:-1] + (head,)),
                    BF16) == ok
    for width, ok in ((512, True), (640, False)):
        assert rule(plan._replace(widths=(width,) * 4 + (1,)), BF16) == ok


def test_emulated_f32_rusink_keeps_the_cuda_core_kernels(emulated):
    """f32 K2 launches the CUDA-core kernels, bit-identical to the
    CUDA-core wrappers' launches."""
    plan, p, ins, dy, _ = rusink_tc_case('brdf', 65, 33, CPU)
    y, calls = launched(lambda: fr.rusink_kernel(plan, *ins, p, None))
    g, bwd_calls = launched(
        lambda: fr.rusink_kernel_bwd(plan, *ins, dy, p, None))
    assert calls == ['nfk_rusink_chain_fwd'] \
        and bwd_calls == ['nfk_rusink_chain_bwd']
    assert torch.equal(y, fr.rusink_kernel_cuda_core(plan, *ins, p, None))
    assert all(torch.equal(u, v) for u, v in zip(
        g, fr.rusink_kernel_bwd_cuda_core(plan, *ins, dy, p, None)))


def test_emulated_rusink_function_hands_packed_weights_to_backward(
        emulated, monkeypatch):
    """K2's autograd Function in bf16 packs the transposed weights once, in
    its forward, and its backward launches the tensor-core K2-bwd over
    them: the cotangents of a launch that packs its own, zero weight
    cotangents."""
    plan, p, ins, dy, _ = rusink_tc_case('w16', 65, 34, CPU)
    packs, pack = [], fm.transposed_weights

    def counted(*args):
        packs.append(pack(*args))
        return packs[-1]
    monkeypatch.setattr(fm, 'transposed_weights', counted)
    flat = [t.clone().requires_grad_() for pair in p for t in pair]
    args = [t.clone().requires_grad_() for t in ins]
    y = fr.RusinkFunction.apply(plan, BF16, *args, *flat)
    grads, calls = launched(lambda: torch.autograd.grad(y, args + flat, dy))
    assert len(packs) == 1 and packs[0] is y.grad_fn.wt
    assert calls == ['nfk_rusink_chain_bwd_tc']
    assert all(torch.equal(g, w) for g, w in zip(
        grads[:3], fr.rusink_kernel_bwd(plan, *ins, dy, p, BF16)))
    assert not any(g.any() for g in grads[3:])


def readings(seeds=(30, 130, 230), sizes=SIZES):
    """Per plan and size, over ``seeds``: the tensor-core kernels against
    the plain bf16 version (the output and the worst cotangent, relative
    norm) and against the emulated CUDA-core kernels."""
    out = []
    for name in sorted(RUSINK_TC_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n, 'fwd_vs_plain': 0.0,
                 'bwd_vs_plain': 0.0, 'fwd_vs_cuda_core': 0.0,
                 'bwd_vs_cuda_core': 0.0}
            for seed in seeds:
                plan, p, ins, dy, held = rusink_tc_case(name, n, seed, CPU)
                y, g = tc_fwd(plan, ins, p), tc_bwd(plan, ins, dy, p)
                for key, val in (
                        ('fwd_vs_plain', rel_norm(y, fr.reference(
                            plan, *ins, p, BF16))),
                        ('bwd_vs_plain', worst(g, plain_grads(
                            plan, ins, dy, p, BF16), held)),
                        ('fwd_vs_cuda_core', rel_norm(
                            y, fr.rusink_kernel_cuda_core(plan, *ins, p,
                                                          BF16))),
                        ('bwd_vs_cuda_core', worst(
                            g, fr.rusink_kernel_bwd_cuda_core(
                                plan, *ins, dy, p, BF16), held))):
                    r[key] = max(r[key], val)
            out.append(r)
    return out


def pallas_readings(seeds=(30, 130, 230), sizes=(65, 130)):
    """Per plan and size, over ``seeds``: the worst cotangent of the
    tensor-core K2-bwd and the least of the f32 kernel's against the Pallas
    kernel's in bf16 in interpret mode, over the rows held."""
    out = []
    for name in sorted(RUSINK_TC_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n, 'tc_vs_pallas': 0.0,
                 'f32_kernel_vs_pallas': np.inf}
            for seed in seeds:
                plan, p, ins, dy, held = rusink_tc_case(name, n, seed, CPU)
                want = pallas_rusink_grads(name, n, seed)
                r['tc_vs_pallas'] = max(r['tc_vs_pallas'], worst(
                    tc_bwd(plan, ins, dy, p), want, held))
                r['f32_kernel_vs_pallas'] = min(
                    r['f32_kernel_vs_pallas'], worst(fr.rusink_kernel_bwd(
                        plan, *ins, dy, p, None), want, held))
            out.append(r)
    return out


def main():
    argparse.ArgumentParser(description=__doc__.split('\n\n')[0]).parse_args()
    with tempfile.TemporaryDirectory() as tmp, emulated_library(tmp):
        for r in readings() + pallas_readings():
            print(json.dumps(r))


if __name__ == '__main__':
    main()
