"""The CUDA kernels' sources, run on the CPU through an emulation of the
CUDA subset they use (``nerfactor_tpu_torch/csrc/emu``), against the
plain PyTorch versions.

g++ compiles ``csrc/*.cu`` with each ``kernel<<<grid, block, ...>>>(...)``
rewritten to ``mock_launch(grid, block, smem, ...)``, which runs the blocks
one after another, each as ``block`` threads with a barrier for
``__syncthreads()``, and fails the launch if a block writes shared memory
past ``smem`` bytes. The library has the real one's C entry points and
is bound through the same ctypes argtypes (``kernel_lib.load``), and the
wrappers take CPU tensors while it is in place. So indexing, shared-memory
layout, barrier and reduction faults of the kernels show here, without a
card; what only the card decides (nvcc's code, FMA contraction, timing)
does not. The card's own tests are the ``cuda``-marked ones.

  JAX_PLATFORMS=cpu python -m tests.test_torch_emu [--csrc DIR]

prints the emulated kernels' readings against the plain versions, and
against the JAX Pallas kernels in interpret mode; ``--csrc`` runs a copy
of the sources instead (e.g. one with a planted fault; it must have the C
entry points these wrappers call); ``--k3_bits`` prints only digests of
bf16 K3-bwd's dW bits, which two trees compare by running it each in its
own checkout.
"""

import argparse
import contextlib
import ctypes
import hashlib
import json
import os
import re
import shutil
import subprocess
import tempfile
from os.path import join

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu.ops import pallas_nerf as pn
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_nerf as fn
from nerfactor_tpu_torch.ops import fused_rusink as fr
from nerfactor_tpu_torch.ops import kernel_lib
from tests.test_torch_chain import (
    DTYPES, DW_TOL, FLAGS, GRAD_TOL, PLANS, RUSINK_PLAN, TOL,
    assert_rusink_close, both, chain_inputs, make_params, rel_norm,
    rusink_case)
from tests.test_torch_chain_routes import (
    LAST_SKIP, case, jax_apply_grads, jax_stash_route)
from tests.test_torch_chain_tc import OFF_TC_PLANS, TC_PLANS
from tests.test_torch_nerf import (
    field_inputs, field_params, jax_field, plain_field, small_plan,
    torch_params)

CPU = torch.device('cpu')
EMU_DIR = join(kernel_lib.CSRC_DIR, 'emu')
LAUNCH = re.compile(r'(\S+?)<<<(.*?)>>>\((.*?)\);', re.S)
SHARED = 'extern __shared__ __align__(16) unsigned char smem[];'


def _translate(src):
    """A CUDA source with its launches rewritten for the emulation."""
    def launch(m):
        grid, block, *rest = m.group(2).split(',')
        return 'mock_launch(%s, %s, %s, [=]() { %s(%s); });' % (
            grid, block, rest[0] if rest else '0', m.group(1), m.group(3))
    return LAUNCH.sub(launch, src).replace(SHARED, '')


# Sources that only the card compiles: kernel P's mma.sync control
CARD_ONLY = ('dot_probe_mma.cu',)


def build(csrc_dir, out_dir):
    """Compiles the emulation of the kernel sources in ``csrc_dir`` (all
    but CARD_ONLY) into ``out_dir``; returns the library's path."""
    cpps = []
    for name in sorted(os.listdir(csrc_dir)):
        if not name.endswith(('.cu', '.cuh')) or name in CARD_ONLY:
            continue
        with open(join(csrc_dir, name)) as f:
            src = _translate(f.read())
        out = join(out_dir, name[:-3] + '.cpp' if name.endswith('.cu') else name)
        with open(out, 'w') as f:
            f.write(src)
        if out.endswith('.cpp'):
            cpps.append(out)
    lib = join(out_dir, 'libnfk_emu.so')
    subprocess.run(['g++', '-std=c++20', '-O1', '-shared', '-fPIC', '-pthread',
                    '-Wno-unknown-pragmas', '-I', EMU_DIR, '-I', out_dir,
                    '-o', lib, *cpps], check=True, capture_output=True)
    return lib


def test_emulated_launch_fails_on_a_shared_memory_overrun(tmp_path):
    """A block that writes past its launch's dynamic shared memory fails
    the launch, as an out-of-range shared access faults on the card."""
    if shutil.which('g++') is None:
        pytest.skip("needs g++ to compile the emulation")
    src = tmp_path / 'src'
    src.mkdir()
    (src / 'overrun.cu').write_text(
        '#include <cuda_runtime.h>\n'
        'namespace {\n' + SHARED + '\n'
        '__global__ void fill(int n) {\n'
        '  for (int i = threadIdx.x; i < n; i += blockDim.x) smem[i] = 1;\n'
        '}\n'
        '}\n'
        'extern "C" int run(int bytes, int n) {\n'
        '  fill<<<2, 32, bytes, nullptr>>>(n);\n'
        '  return cudaGetLastError();\n'
        '}\n')
    run = ctypes.CDLL(build(str(src), str(tmp_path))).run
    assert run(256, 256) == 0
    assert run(256, 257) != 0
    assert run(256, 0) == 0


def _check_on_cpu(inputs):
    """fused_mlp.check_inputs without its device check."""
    for name, t, cols in inputs:
        if t.dtype != torch.float32 or tuple(t.shape) != (
                inputs[0][1].shape[0], cols):
            raise ValueError("%s: %s %s" % (name, t.dtype, tuple(t.shape)))
    return [t.contiguous() for _, t, _ in inputs]


# The library entries the wrappers called, in order (emulation only)
CALLS = []


def _run_on_cpu(entry, device, *args, stream=True):
    CALLS.append(entry)
    code = kernel_lib.entry(entry)(*(args + (None,) if stream else args))
    kernel_lib.check(code, entry)


def _check_tensor_on_cpu(name, t, dtype, numel):
    """fused_nerf.check_tensor without its device check."""
    if t.dtype != dtype or t.numel() != numel or not t.is_contiguous():
        raise ValueError("%s: %s %s" % (name, t.dtype, tuple(t.shape)))


@contextlib.contextmanager
def emulation(lib_path):
    """Within: the kernel wrappers launch the emulated library on CPU
    tensors."""
    saved = (kernel_lib.build, kernel_lib._lib, fm.check_inputs, fm.run,
             fn.check_tensor)
    kernel_lib.build, kernel_lib._lib = (lambda: lib_path), None
    fm.check_inputs, fm.run = _check_on_cpu, _run_on_cpu
    fn.check_tensor = _check_tensor_on_cpu
    try:
        yield
    finally:
        (kernel_lib.build, kernel_lib._lib, fm.check_inputs, fm.run,
         fn.check_tensor) = saved


@contextlib.contextmanager
def emulated_library(out_dir):
    """Within: the kernel wrappers launch the emulation of the package's
    CUDA sources, compiled into ``out_dir``, on CPU tensors."""
    if shutil.which('g++') is None:
        pytest.skip("needs g++ to compile the emulation of the CUDA sources")
    with emulation(build(kernel_lib.CSRC_DIR, out_dir)):
        yield


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    with emulated_library(str(tmp_path_factory.mktemp('emu'))):
        yield


# The joint model's chains (test_torch_chain.PLANS) and two plans only the
# tensor-core K1-bwd treats apart: hidden width 272, two column passes a
# product, with a skip consumer; width 24, off the mma step (padded to 32),
# with a 2-wide linear head.
CHAIN_PLANS = dict(PLANS, w272=TC_PLANS['w272'], w24=TC_PLANS['w24'])
ALL_PLANS = dict(CHAIN_PLANS, **OFF_TC_PLANS)


def chain_case(name, n, seed):
    _, _, plan, p = both(ALL_PLANS[name], seed=seed)
    x = torch.from_numpy(chain_inputs(plan, n=n, seed=seed + 1))
    dy = torch.from_numpy(np.random.RandomState(seed + 2).uniform(
        -1, 1, (n, plan.widths[-1])).astype(np.float32))
    return plan, p, x, dy


def plain_grads(plan, x, dy, p, td, ref=fm.chain_reference):
    ins = [x.clone().requires_grad_()] + [
        t.clone().requires_grad_() for pair in p for t in pair]
    y = ref(plan, ins[0], list(zip(ins[1::2], ins[2::2])), td)
    return y.detach(), torch.autograd.grad(y, ins, dy)


@pytest.mark.parametrize('n', [1, 50, 130])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_chain_kernels_match_plain(name, mode, n, emulated):
    """K1-fwd and K1-bwd (every flag combination) from the CUDA source
    against the plain version, with the card tests' bounds; K1-bwd's dW is
    bit-identical across two launches."""
    plan, p, x, dy = chain_case(name, n, seed=30)
    td = DTYPES[mode][1]
    y, want = plain_grads(plan, x, dy, p, td)
    np.testing.assert_allclose(fm.chain_kernel(plan, x, p, td).numpy(),
                               y.numpy(), **TOL[mode])
    for needs_dx, needs_dw in FLAGS:
        dx, dparams = fm.chain_kernel_bwd(plan, x, dy, p, td, needs_dx,
                                          needs_dw)
        if needs_dx and mode == 'f32':
            np.testing.assert_allclose(dx.numpy(), want[0].numpy(),
                                       **GRAD_TOL[mode])
        elif needs_dx:
            assert rel_norm(dx, want[0]) <= DW_TOL[mode]
        if needs_dw:
            got = [t for pair in dparams for t in pair]
            for g, w in zip(got, want[1:]):
                assert rel_norm(g, w) <= DW_TOL[mode]
            again = fm.chain_kernel_bwd(plan, x, dy, p, td, needs_dx,
                                        needs_dw)[1]
            assert all(torch.equal(a, b) for pa, pb in zip(dparams, again)
                       for a, b in zip(pa, pb))


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_emulated_rusink_kernels_match_plain(mode, emulated):
    """K2-fwd and K2-bwd from the CUDA source against the plain version
    (the last 3 rows, a == b, held as in test_torch_chain)."""
    _, _, plan, p = both(RUSINK_PLAN, seed=31)
    z, a, b = (torch.from_numpy(v) for v in rusink_case(seed=32))
    dy = torch.from_numpy(np.random.RandomState(33).uniform(
        -1, 1, (z.shape[0], 1)).astype(np.float32))
    td = DTYPES[mode][1]
    ins = [t.clone().requires_grad_() for t in (z, a, b)]
    y = fr.reference(plan, *ins, p, td)
    want = torch.autograd.grad(y, ins, dy)
    assert_rusink_close(fr.rusink_kernel(plan, z, a, b, p, td).numpy(),
                        y.detach().numpy(), mode)
    got = fr.rusink_kernel_bwd(plan, z, a, b, dy, p, td)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[:-3], w.numpy()[:-3],
                                   **GRAD_TOL[mode])
        assert torch.isfinite(g).all()


def kernel_grads(plan, x, dy, p, td):
    """K1-bwd's [dx, dW0, db0, ...]."""
    dx, dparams = fm.chain_kernel_bwd(plan, x, dy, p, td)
    return [dx] + [t for pair in dparams for t in pair]


def grad_errs(got, want):
    """(dx, worst dW/db leaf) relative norms of ``got`` against ``want``."""
    return rel_norm(got[0], want[0]), max(
        rel_norm(g, w) for g, w in zip(got[1:], want[1:]))


def pallas_grads(name, n, seed, mode):
    """[dx, dW0, db0, ...] of the JAX Pallas kernel in interpret mode, on
    chain_case's inputs."""
    jplan, jp, _, _ = both(ALL_PLANS[name], seed=seed)
    x = chain_inputs(jplan, n=n, seed=seed + 1)
    dy = np.random.RandomState(seed + 2).uniform(
        -1, 1, (n, jplan.widths[-1])).astype(np.float32)
    pm.INTERPRET = True
    try:
        gx, gp = jax.grad(lambda x_, p_: jnp.sum(pm.apply_chain(
            jplan, x_, p_, compute_dtype=DTYPES[mode][0]) * dy),
            argnums=(0, 1))(jnp.asarray(x), jp)
    finally:
        pm.INTERPRET = False
    return [torch.from_numpy(np.array(g)) for g in
            [gx] + [t for pair in gp for t in pair]]


# In bf16 the plain version rounds every cotangent at each cast, so at
# these sizes it parts from the kernel by about as much as from the f32
# gradient (test_torch_chain DW_TOL). The TPU kernel rounds where K1-bwd
# does (d_h in f32, d_pre in bf16), so the two are held close. Readings
# over the three plans at 50, 130 and 700 rows and 3 seeds (python -m
# tests.test_torch_emu): K1-bwd <= 0.0070 (dW/db leaves) and 0.0044 (dx);
# the f32 kernel, i.e. a kernel that computed the f32 gradient, >= 0.040
# and 0.013. With dW only, on the tensor cores (tc_readings, CHAIN_PLANS
# at 50 and 130 rows): <= 0.0070 against >= 0.040.
PALLAS_TOL_BF16 = 0.01


@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_bf16_grads_match_interpreted_pallas_kernel(name, emulated):
    plan, p, x, dy = chain_case(name, 130, seed=30)
    dx, dw = grad_errs(kernel_grads(plan, x, dy, p, torch.bfloat16),
                       pallas_grads(name, 130, 30, 'bf16'))
    assert dx <= PALLAS_TOL_BF16 and dw <= PALLAS_TOL_BF16


# ------ bf16 K1-bwd with dW only: the tensor-core design ------

def tc_dparams(plan, x, dy, p):
    """bf16 K1-bwd's [dW0, db0, ...] with dW only, checking that the call
    ran the tensor-core entry."""
    del CALLS[:]
    _, dparams = fm.chain_kernel_bwd(plan, x, dy, p, torch.bfloat16,
                                     needs_dx=False)
    assert 'nfk_chain_bwd_tc' in CALLS and 'nfk_chain_bwd' not in CALLS
    return [t for pair in dparams for t in pair]


def cuda_core_dparams(plan, x, dy, p, td):
    """The CUDA-core K1-bwd's [dW0, db0, ...] (with dx, which keeps it on
    that kernel)."""
    del CALLS[:]
    _, dparams = fm.chain_kernel_bwd(plan, x, dy, p, td, needs_dx=True)
    assert 'nfk_chain_bwd' in CALLS
    return [t for pair in dparams for t in pair]


# The tensor-core K1-bwd rounds where the CUDA-core one does (posts and
# d_pre at bf16, d_h in f32); only the order of its sums differs. The
# emulated mma sums its 16 products in order with fmaf, so here the two
# kernels part by a few f32 roundings. Readings (python -m
# tests.test_torch_emu, tc_readings) over CHAIN_PLANS at 50 and 130 rows
# and 3 seeds: the two kernels <= 2.7e-7 apart (worst dW/db leaf); the
# tensor-core kernel against the Pallas kernel <= 0.0070, the f32 kernel
# against it >= 0.040. On the card, where a d_pre that mma.sync's sum
# puts next to a bf16 rounding boundary rounds the other way, the two
# kernels part by more (test_torch_chain_tc).
TC_VS_CUDA_CORE_TOL = 1e-5


@pytest.mark.parametrize('name', sorted(CHAIN_PLANS))
def test_emulated_bf16_dw_only_matches_interpreted_pallas_kernel(name,
                                                                 emulated):
    """bf16 K1-bwd with dW only (the joint step's lvis call), which runs
    phase 1 and the dW pass on the tensor cores: every dW/db leaf within
    PALLAS_TOL_BF16 of the Pallas kernel's in interpret mode, within
    TC_VS_CUDA_CORE_TOL of the CUDA-core kernel's, and bit-identical across
    two launches."""
    plan, p, x, dy = chain_case(name, 130, seed=30)
    got = tc_dparams(plan, x, dy, p)
    want = pallas_grads(name, 130, 30, 'bf16')[1:]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert max(rel_norm(g, w) for g, w in zip(got, want)) <= PALLAS_TOL_BF16
    core = cuda_core_dparams(plan, x, dy, p, torch.bfloat16)
    assert max(rel_norm(g, w) for g, w in zip(got, core)) \
        <= TC_VS_CUDA_CORE_TOL
    assert all(torch.equal(a, b)
               for a, b in zip(got, tc_dparams(plan, x, dy, p)))


@pytest.mark.parametrize('name', sorted(OFF_TC_PLANS))
def test_emulated_bf16_dw_only_off_the_tensor_cores(name, emulated):
    """bf16 K1-bwd with dW only on a plan that the rule keeps off the
    tensor cores runs the CUDA-core kernel: every dW/db leaf within
    PALLAS_TOL_BF16 of the Pallas kernel's in interpret mode."""
    plan, p, x, dy = chain_case(name, 70, seed=30)
    del CALLS[:]
    _, dparams = fm.chain_kernel_bwd(plan, x, dy, p, torch.bfloat16,
                                     needs_dx=False)
    assert 'nfk_chain_bwd' in CALLS and 'nfk_chain_bwd_tc' not in CALLS
    got = [t for pair in dparams for t in pair]
    want = pallas_grads(name, 70, 30, 'bf16')[1:]
    assert [g.shape for g in got] == [w.shape for w in want]
    assert max(rel_norm(g, w) for g, w in zip(got, want)) <= PALLAS_TOL_BF16


@pytest.mark.parametrize('name,n', [('w24', 1), ('w24', 70), ('w272', 1),
                                    ('w272', 70)])
def test_emulated_tc_bwd_matches_plain(name, n, emulated):
    """Past one column pass (272) and off the mma step (24), at 1 and 70
    rows: the tensor-core K1-bwd's dW/db against autograd of the plain
    bf16 version within DW_TOL, as every bf16 K1-bwd."""
    plan, p, x, dy = chain_case(name, n, seed=31)
    want = plain_grads(plan, x, dy, p, torch.bfloat16)[1][1:]
    got = tc_dparams(plan, x, dy, p)
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_norm(g, w) <= DW_TOL['bf16']


@pytest.mark.parametrize('name,n', [('lvis', 1), ('lvis', 130),
                                    ('normal', 70), ('w272', 130)])
def test_emulated_chain_dw_pass_matches_float64(name, n, emulated):
    """The dW pass that K1-bwd shares with K3-bwd, over the chain's table,
    against X^T D of the same scratch in float64 (a skip consumer's two K
    segments and a 272-wide layer's two tiles of K and of N included);
    bit-identical across two launches."""
    _, _, plan, _ = both(CHAIN_PLANS[name])
    plan = fm.mma_plan(plan)
    tab, tile = fm.chain_dw_table(plan, CPU)
    scratch = dw_scratch(tab, n, seed=n)
    got = fm.dw_pass(tab, tile, scratch, n)
    want = fm.dw_reference(tab, scratch, n)
    n_hidden = sum(d * w for d, w in zip(fm.layer_in_dims(plan),
                                         plan.widths[:-1]))
    assert got.shape == want.shape == (n_hidden,)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, fm.dw_pass(tab, tile, scratch, n))


# ------ bf16 K1-fwd and K3-fwd on the tensor cores ------

# The tensor-core forwards round where the CUDA-core ones do (posts at
# bf16, heads in f32 from them); only the order of the sums moves. Readings
# (python -m tests.test_torch_emu, fwd_readings: CHAIN_PLANS at 1, 50 and
# 130 rows and K3's w32, w256, w272 at 1-130 rows, 2 seeds), relative norm
# of the output: the tensor-core kernel <= 1.7e-7 from the CUDA-core bf16
# kernel (TC_VS_CUDA_CORE_TOL), where the f32 kernel, the control, reads
# >= 1.9e-4 from it; <= 0.0030 from the Pallas kernel in interpret mode
# and <= 0.0051 from the plain bf16 version, both held elementwise by TOL.


def fwd_calls(launch):
    """``launch()``'s output and the library entries it called."""
    del CALLS[:]
    out = launch()
    return out, list(CALLS)


def pallas_chain_fwd(name, n, seed):
    """The JAX Pallas K1-fwd in interpret mode on chain_case's inputs."""
    jplan, jp, _, _ = both(ALL_PLANS[name], seed=seed)
    x = chain_inputs(jplan, n=n, seed=seed + 1)
    pm.INTERPRET = True
    try:
        y = pm.apply_chain(jplan, jnp.asarray(x), jp,
                           compute_dtype=jnp.bfloat16)
    finally:
        pm.INTERPRET = False
    return torch.from_numpy(np.array(y))


@pytest.mark.parametrize('name,n', [
    ('lvis', 1), ('lvis', 50), ('lvis', 130), ('normal', 130),
    ('brdf_z', 50), ('w24', 130), ('w272', 130)])
def test_emulated_tc_fwd_matches_interpreted_pallas_kernel(name, n,
                                                           emulated):
    """bf16 K1-fwd runs the tensor-core kernel (a skip consumer's two K
    segments; width 24 padded to 32; width 272 past one column pass, the
    second buffer): within TOL of the Pallas kernel in interpret mode and
    of the plain bf16 version, within TC_VS_CUDA_CORE_TOL of the CUDA-core
    kernel, bit-identical across two launches."""
    plan, p, x, _ = chain_case(name, n, seed=30)
    y, calls = fwd_calls(lambda: fm.chain_kernel(plan, x, p, torch.bfloat16))
    assert 'nfk_chain_fwd_tc' in calls and 'nfk_chain_fwd' not in calls
    for want in (pallas_chain_fwd(name, n, 30),
                 fm.chain_reference(plan, x, p, torch.bfloat16)):
        np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL['bf16'])
    assert rel_norm(y, fm.chain_kernel_cuda_core(
        plan, x, p, torch.bfloat16)) <= TC_VS_CUDA_CORE_TOL
    assert torch.equal(y, fm.chain_kernel(plan, x, p, torch.bfloat16))


# What the rule keeps on the CUDA-core K1-fwd, chain_fwd_kernel: (plan,
# compute dtype, the launcher, its plain version). The lvis chain in f32
# on both routes and with a skip after the head (K1w; in bf16 the stash
# route and K1w take the tensor cores, test_torch_emu_stash and
# test_torch_emu_last_skip); the embedding into the head; a head wider
# than 8; hidden layers too wide for the block.
OFF_TC_FWD = {
    'f32': (TC_PLANS['lvis'], None, fm.chain_kernel, fm.chain_reference),
    'stash': (TC_PLANS['lvis'], None,
              lambda *a: fm.chain_kernel_stash(*a)[0],
              fm.chain_reference_stash),
    'last_skip': (LAST_SKIP['lvis'], None, fm.chain_kernel_last_skip,
                  fm.chain_reference),
    'skip_head': (OFF_TC_PLANS['skip_head'], torch.bfloat16,
                  fm.chain_kernel, fm.chain_reference),
    'head9': (([(3, 4), (3, 2)], (32, 32, 9), ('relu', 'relu', None), ()),
              torch.bfloat16, fm.chain_kernel, fm.chain_reference),
    'w704': (OFF_TC_PLANS['w704'], torch.bfloat16, fm.chain_kernel,
             fm.chain_reference),
}


@pytest.mark.parametrize('case', sorted(OFF_TC_FWD))
def test_emulated_fwd_off_the_tensor_cores(case, emulated):
    """The K1-fwd calls that the rule keeps off the tensor cores launch the
    CUDA-core kernel, within TOL of the route's plain version."""
    args, cd, launch, plain = OFF_TC_FWD[case]
    _, _, plan, p = both(args, seed=32)
    x = torch.from_numpy(chain_inputs(plan, n=70, seed=33))
    y, calls = fwd_calls(lambda: launch(plan, x, p, cd))
    assert 'nfk_chain_fwd' in calls and 'nfk_chain_fwd_tc' not in calls
    np.testing.assert_allclose(y.numpy(), plain(plan, x, p, cd).numpy(),
                               **TOL['bf16' if cd else 'f32'])


# ------ K1r (the stash route) and K1w (a skip after the last layer) ------

def torch_case(plan_args, n, seed):
    """test_torch_chain_routes.case with torch tensors."""
    jplan, jp, tplan, tp, x, dy = case(plan_args, n, seed)
    return jplan, jp, tplan, tp, torch.from_numpy(x), torch.from_numpy(dy)


def assert_dparams(got, want, mode):
    """Each dW/db leaf within DW_TOL of its norm."""
    for g, w in zip([t for pair in got for t in pair], want):
        assert rel_norm(g, torch.as_tensor(w)) <= DW_TOL[mode]


def assert_same_dparams(a, b):
    assert all(torch.equal(u, v) for pa, pb in zip(a, b)
               for u, v in zip(pa, pb))


@pytest.mark.parametrize('n', [50, 130])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_stash_kernels_match_plain(name, mode, n, emulated):
    """K1r-fwd (with and without the stash) and K1r-bwd (with and without
    dx; dW/db always) from the CUDA source against the plain stash route;
    the stash against trig_stash at the operand type (f32 1e-6, bf16 one
    step of 2^-8); dW/db bit-identical across two launches."""
    _, _, tplan, tp, x, dy = torch_case(PLANS[name], n, seed=50)
    td = DTYPES[mode][1]
    y_p, want = plain_grads(tplan, x, dy, tp, td, fm.chain_reference_stash)
    y, stash = fm.chain_kernel_stash(tplan, x, tp, td, with_stash=True)
    y2, none = fm.chain_kernel_stash(tplan, x, tp, td)
    assert none is None and torch.equal(y, y2)
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), **TOL[mode])
    assert stash.dtype == fm.kernel_dtype(td)
    np.testing.assert_allclose(
        stash.float().numpy(),
        fm.trig_stash(tplan, x).to(stash.dtype).float().numpy(), rtol=0,
        atol=1e-6 if mode == 'f32' else 2 ** -8)
    for needs_dx in (True, False):
        dx, dparams = fm.chain_kernel_stash_bwd(tplan, x, dy, stash, tp, td,
                                                needs_dx=needs_dx)
        if not needs_dx:
            assert dx is None
        elif mode == 'f32':
            np.testing.assert_allclose(dx.numpy(), want[0].numpy(),
                                       **GRAD_TOL[mode])
        else:
            assert rel_norm(dx, want[0]) <= DW_TOL[mode]
        assert_dparams(dparams, want[1:], mode)
        assert_same_dparams(dparams, fm.chain_kernel_stash_bwd(
            tplan, x, dy, stash, tp, td, needs_dx=needs_dx)[1])


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_stash_kernels_match_interpreted_pallas_kernel(name, mode,
                                                                emulated):
    """K1r from the CUDA source against the JAX row-major trig kernels in
    interpret mode: f32 within TOL / GRAD_TOL; bf16 output within TOL, the
    stash one bf16 step, and dx and every dW/db leaf within
    PALLAS_TOL_BF16 of their norms (both round where the TPU kernel does)."""
    jplan, jp, tplan, tp, x, dy = torch_case(PLANS[name], 130, seed=51)
    jd, td = DTYPES[mode]
    y_j, stash_j, dx_j, dw_j = jax_stash_route(jplan, jp, x.numpy(),
                                               dy.numpy(), jd)
    y, stash = fm.chain_kernel_stash(tplan, x, tp, td, with_stash=True)
    dx, dparams = fm.chain_kernel_stash_bwd(tplan, x, dy, stash, tp, td)
    np.testing.assert_allclose(y.numpy(), y_j, **TOL[mode])
    np.testing.assert_allclose(stash.float().numpy(), stash_j, rtol=0,
                               atol=1e-6 if mode == 'f32' else 2 ** -8)
    got = [dx] + [t for pair in dparams for t in pair]
    for g, w in zip(got, [dx_j] + dw_j):
        if mode == 'f32':
            np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL[mode])
        else:
            assert rel_norm(g, torch.tensor(w)) <= PALLAS_TOL_BF16


@pytest.mark.parametrize('n', [50, 130])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_last_skip_kernels_match_plain(name, mode, n, emulated):
    """K1w-fwd ([head | embedding]) and K1w-bwd (every flag combination;
    dy's embedding columns reach dx) from the CUDA source against the
    plain version; dW/db bit-identical across two launches."""
    _, _, tplan, tp, x, dy = torch_case(LAST_SKIP[name], n, seed=52)
    td = DTYPES[mode][1]
    y_p, want = plain_grads(tplan, x, dy, tp, td)
    y = fm.chain_kernel_last_skip(tplan, x, tp, td)
    assert y.shape == (n, fm.out_dim(tplan))
    np.testing.assert_allclose(y.numpy(), y_p.numpy(), **TOL[mode])
    for needs_dx, needs_dw in FLAGS:
        dx, dparams = fm.chain_kernel_last_skip_bwd(tplan, x, dy, tp, td,
                                                    needs_dx, needs_dw)
        if needs_dx and mode == 'f32':
            np.testing.assert_allclose(dx.numpy(), want[0].numpy(),
                                       **GRAD_TOL[mode])
        elif needs_dx:
            assert rel_norm(dx, want[0]) <= DW_TOL[mode]
        if needs_dw:
            assert_dparams(dparams, want[1:], mode)
            assert_same_dparams(dparams, fm.chain_kernel_last_skip_bwd(
                tplan, x, dy, tp, td, needs_dx, needs_dw)[1])


@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_last_skip_kernels_match_interpreted_pallas_kernel(
        name, emulated):
    """f32 K1w from the CUDA source against the JAX package's K1w route in
    interpret mode (output and gradients); in bf16 the emulated kernel
    follows the JAX chain_reference(bf16) and parts from the JAX kernel's
    bf16 call, which is its f32 call (the documented deviation)."""
    jplan, jp, tplan, tp, x, dy = torch_case(LAST_SKIP[name], 130, seed=53)
    pm.INTERPRET = True
    try:
        y_j, want = jax_apply_grads(pm.apply_chain, jplan, jp, x.numpy(),
                                    dy.numpy())
        y_j16 = np.asarray(pm.apply_chain(jplan, jnp.asarray(x.numpy()), jp,
                                          compute_dtype=jnp.bfloat16))
    finally:
        pm.INTERPRET = False
    np.testing.assert_allclose(fm.chain_kernel_last_skip(tplan, x, tp).numpy(),
                               y_j, **TOL['f32'])
    dx, dparams = fm.chain_kernel_last_skip_bwd(tplan, x, dy, tp)
    for g, w in zip([dx] + [t for pair in dparams for t in pair], want):
        np.testing.assert_allclose(g.numpy(), w, **GRAD_TOL['f32'])
    y16 = fm.chain_kernel_last_skip(tplan, x, tp, torch.bfloat16).numpy()
    np.testing.assert_array_equal(y_j16, y_j)
    np.testing.assert_allclose(y16, np.asarray(pm.chain_reference(
        jplan, jnp.asarray(x.numpy()), jp, compute_dtype=jnp.bfloat16)),
        **TOL['bf16'])
    assert np.abs(y16 - y_j16).max() > 1e-3


# ------ K3 ------

# Width 32 (depth 4), and nerf.ini's width 256 (depth 8, skip after layer
# 4, rgb 128): two column passes per layer, a 319-wide skip consumer, and
# the backward's row tile (64 rows in bf16, the f32 kernel's 16 from its
# layout), so that 70 rows span several tiles and several slices. Width
# 272: two column passes a product in bf16 K3-bwd too (its passes are 256
# wide), each reading the whole operand.
NERF_PLANS = {'w32': small_plan(),
              'w256': dict(small_plan(), width=256, depth=8, skip_at=4,
                           rgb_widths=(128, 3)),
              'w272': dict(small_plan(), width=272)}


def nerf_case(name, n, seed):
    nplan = fn.make_nerf_plan(**NERF_PLANS[name])
    p = field_params(nplan, seed)
    return nplan, p, [torch.from_numpy(a) for a in field_inputs(n, seed + 1)]


def nerf_kernel_grads(nplan, ins, p, td):
    return fn.flatten(fn.nerf_kernel_bwd(nplan, *ins, torch_params(p), td))


@pytest.mark.parametrize('name,n', [('w32', 1), ('w32', 50), ('w32', 130),
                                    ('w256', 1), ('w256', 70)])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_emulated_nerf_kernels_match_plain(name, n, mode, emulated):
    """K3-fwd and K3-bwd from the CUDA source against the plain version:
    f32 outputs within 1e-5 and each dW/db leaf within 1e-5 of its norm;
    bf16 outputs within TOL (the kernel also rounds the bottleneck and rgb
    layer 0's operands). K3-bwd's dW is bit-identical across launches."""
    nplan, p, ins = nerf_case(name, n, seed=40)
    td = DTYPES[mode][1]
    rgb, sigma, want = plain_field(nplan, *ins, torch_params(p), td)
    got_rgb, got_sigma = fn.nerf_kernel(nplan, ins[0], ins[1],
                                        torch_params(p), td)
    np.testing.assert_allclose(got_rgb.numpy(), rgb.numpy(), **TOL[mode])
    np.testing.assert_allclose(got_sigma.numpy(), sigma.numpy(), **TOL[mode])
    got = nerf_kernel_grads(nplan, ins, p, td)
    if mode == 'f32':
        for g, w in zip(got, want):
            assert rel_norm(g, w) <= 1e-5
    again = nerf_kernel_grads(nplan, ins, p, td)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


# As K1's PALLAS_TOL_BF16: the plain version's autograd rounds every
# cotangent at each cast, the TPU kernel where K3-bwd does (d_h f32, d_pre
# bf16). K3 also stores the trunk's output and the rgb hidden layer at bf16
# where the TPU kernel keeps them f32, so the two sit further apart than
# K1's pair. Readings over 2 seeds (python -m tests.test_torch_emu), the
# same for the CUDA-core and the tensor-core bf16 backward: w32 at 130 rows
# <= 0.028, w256 at 70 rows <= 0.048; w272 at 70 rows (tensor cores)
# <= 0.053; the f32 kernel, i.e. a kernel that computed the f32 gradient,
# >= 0.088.
NERF_PALLAS_TOL_BF16 = 0.07


def test_emulated_nerf_bf16_grads_match_interpreted_pallas_kernel(emulated):
    nplan, p, ins = nerf_case('w32', 130, seed=20)
    want = jax_field(pn.make_nerf_plan(**NERF_PLANS['w32']), p,
                     *[a.numpy() for a in ins], jnp.bfloat16, True)[2]
    got = nerf_kernel_grads(nplan, ins, p, torch.bfloat16)
    assert max(rel_norm(g, torch.tensor(w))
               for g, w in zip(got, want)) <= NERF_PALLAS_TOL_BF16


def test_emulated_bf16_nerf_bwd_past_one_column_pass(emulated):
    """bf16 K3-bwd at trunk width 272, where every trunk, bottleneck and
    d_pre @ W^T product takes two column passes, each over its whole
    operand, against the Pallas kernel in interpret mode; f32 K3-bwd
    against the plain version."""
    nplan, p, ins = nerf_case('w272', 70, seed=22)
    want = jax_field(pn.make_nerf_plan(**NERF_PLANS['w272']), p,
                     *[a.numpy() for a in ins], jnp.bfloat16, True)[2]
    got = nerf_kernel_grads(nplan, ins, p, torch.bfloat16)
    assert max(rel_norm(g, torch.tensor(w))
               for g, w in zip(got, want)) <= NERF_PALLAS_TOL_BF16
    want = plain_field(nplan, *ins, torch_params(p), None)[2]
    for g, w in zip(nerf_kernel_grads(nplan, ins, p, None), want):
        assert rel_norm(g, w) <= 1e-5


# The tensor-core building block (csrc/mma_bf16.cuh) at sizes that are
# not multiples of its fragments: ragged rows, columns past one 256-wide
# pass, K not a multiple of 16.
TC_SHAPES = [(1, 8, 16), (37, 20, 45), (64, 96, 80), (130, 300, 33)]


def bf16_values(rng, shape):
    return torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32)) \
        .to(torch.bfloat16)


@pytest.mark.parametrize('m,n,k', TC_SHAPES)
def test_emulated_tc_matmul_matches_float64(m, n, k, emulated):
    """The emulated mma.sync fragments, loaders and cp.async pipeline give
    the float64 product of the same bf16 values to f32 accumulation."""
    rng = np.random.RandomState(m + n + k)
    a, b = bf16_values(rng, (m, k)), bf16_values(rng, (n, k))
    got = fn.tc_matmul(a, b).double()
    want = fn.tc_matmul_reference(a, b)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def dw_scratch(tab, n, seed):
    """A bf16 scratch of n rows (whole 64-row tiles) laid out as the
    fused_mlp.DwTable ``tab`` says, of values in [-1, 1)."""
    return bf16_values(np.random.RandomState(seed),
                       (fm.scratch_values(tab, n),))


@pytest.mark.parametrize('name,n', [('w32', 1), ('w32', 50), ('w32', 130),
                                    ('w256', 130)])
def test_emulated_dw_pass_matches_float64(name, n, emulated):
    """K3-bwd's dW pass alone against X^T D of the same scratch in float64
    (every dense layer, the skip consumer's and rgb layer 0's two K
    segments included), over 1 to 3 row chunks; bit-identical across two
    launches."""
    nplan = fn.make_nerf_plan(**NERF_PLANS[name])
    tab, tile = fn.dw_table(nplan, CPU)
    scratch = dw_scratch(tab, n, seed=n)
    got = fm.dw_pass(tab, tile, scratch, n)
    want = fm.dw_reference(tab, scratch, n)
    assert got.shape == want.shape == (fn.layout(nplan)['n_dense'],)
    np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)
    assert torch.equal(got, fm.dw_pass(tab, tile, scratch, n))


# A field whose trunk and rgb hidden widths are off the mma K step (16)
NERF_PLAN_W24 = dict(NERF_PLANS['w32'], width=24, rgb_widths=(8, 3))


def test_padded_plan_keeps_the_field_and_its_gradients():
    """bf16 K3-bwd runs a plan off the mma step as mma_plan's, over the
    weights zero-padded to it: the plain version gives the same outputs
    and, once unpadded, the same weight gradients on both (f32)."""
    nplan = fn.make_nerf_plan(**NERF_PLAN_W24)
    kplan = fn.mma_plan(nplan)
    assert kplan.trunk_plan.widths == (32,) * 4 and kplan.rgb_widths == (16, 3)
    assert fn.mma_plan(kplan) == kplan
    p = torch_params(field_params(nplan, 7))
    ins = [torch.from_numpy(a) for a in field_inputs(10, 8)]
    padded = fn.pad_params(nplan, p)
    for a, b in zip(fn.flatten(fn.unpad_grads(nplan, padded)), fn.flatten(p)):
        assert torch.equal(a, b)
    rgb, sigma, want = plain_field(nplan, *ins, p, None)
    prgb, psigma, got = plain_field(kplan, *ins, padded, None)
    np.testing.assert_allclose(prgb.numpy(), rgb.numpy(), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(psigma.numpy(), sigma.numpy(), rtol=1e-6,
                               atol=1e-6)
    got = fn.flatten(fn.unpad_grads(nplan, fn.unflatten(kplan, got)))
    for g, w in zip(got, want):
        assert g.shape == w.shape and rel_norm(g, w) <= 1e-6


def test_emulated_bf16_nerf_bwd_pads_widths_off_the_mma_step(emulated):
    """bf16 K3-bwd at trunk width 24 and rgb hidden width 8 (padded to 32
    and 16 for the tensor cores) against the Pallas kernel in interpret
    mode, as at the mma step's widths; f32 K3-bwd takes such widths as
    they are."""
    nplan = fn.make_nerf_plan(**NERF_PLAN_W24)
    p = field_params(nplan, 7)
    ins = [torch.from_numpy(a) for a in field_inputs(70, 8)]
    want = jax_field(pn.make_nerf_plan(**NERF_PLAN_W24), p,
                     *[a.numpy() for a in ins], jnp.bfloat16, True)[2]
    got = nerf_kernel_grads(nplan, ins, p, torch.bfloat16)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert max(rel_norm(g, torch.tensor(w))
               for g, w in zip(got, want)) <= NERF_PALLAS_TOL_BF16
    want = plain_field(nplan, *ins, torch_params(p), None)[2]
    for g, w in zip(nerf_kernel_grads(nplan, ins, p, None), want):
        assert rel_norm(g, w) <= 1e-5


# K3's plans and one off the mma step (widths 24 and 8, padded to 32 and
# 16)
NERF_FWD_PLANS = dict(NERF_PLANS, w24=NERF_PLAN_W24)


def pallas_field_fwd(name, p, pts, views):
    """The JAX Pallas K3-fwd (bf16) in interpret mode: [rgb | sigma]."""
    jp = tuple([(jnp.asarray(w), jnp.asarray(b)) for w, b in g] for g in p)
    plan = pn.make_nerf_plan(**NERF_FWD_PLANS[name])
    pm.INTERPRET = True
    try:
        rgb, sigma = pn.apply_nerf(plan, jnp.asarray(pts.numpy()),
                                   jnp.asarray(views.numpy()), jp,
                                   compute_dtype=jnp.bfloat16)
    finally:
        pm.INTERPRET = False
    return torch.from_numpy(np.concatenate([rgb, sigma], axis=1))


@pytest.mark.parametrize('name,n', [('w32', 1), ('w32', 50), ('w32', 130),
                                    ('w256', 70), ('w272', 70), ('w24', 50)])
def test_emulated_tc_nerf_fwd_matches_interpreted_pallas_kernel(name, n,
                                                                emulated):
    """bf16 K3-fwd runs the tensor-core kernel (nerf.ini's widths at w256;
    width 272 past one column pass, the second buffer; widths 24 and 8
    padded to 32 and 16): [rgb | sigma] within TOL of the Pallas kernel in
    interpret mode and of the plain bf16 version, within
    TC_VS_CUDA_CORE_TOL of the CUDA-core kernel, bit-identical across two
    launches. f32 keeps the CUDA-core kernel."""
    nplan = fn.make_nerf_plan(**NERF_FWD_PLANS[name])
    p = field_params(nplan, 24)
    pts, views = (torch.from_numpy(a) for a in field_inputs(n, 25)[:2])
    tp = torch_params(p)

    def fwd(cd):
        return torch.cat(fn.nerf_kernel(nplan, pts, views, tp, cd), dim=1)
    y, calls = fwd_calls(lambda: fwd(torch.bfloat16))
    assert 'nfk_nerf_fwd_tc' in calls and 'nfk_nerf_fwd' not in calls
    for want in (pallas_field_fwd(name, p, pts, views), torch.cat(
            fn.nerf_reference(nplan, pts, views, tp, torch.bfloat16), 1)):
        np.testing.assert_allclose(y.numpy(), want.numpy(), **TOL['bf16'])
    assert rel_norm(y, torch.cat(fn.nerf_kernel_cuda_core(
        nplan, pts, views, tp, torch.bfloat16), 1)) <= TC_VS_CUDA_CORE_TOL
    assert torch.equal(y, fwd(torch.bfloat16))
    _, calls = fwd_calls(lambda: fwd(None))
    assert calls == ['nfk_nerf_fwd']


def test_emulated_chain_kernels_at_nerf_width(emulated):
    """K1 on NeRF's no-views chain (256 x 8, skip after layer 4, a 4-wide
    head) in f32, whose backward keeps its posts only at 16 rows."""
    plan = fm.make_plan([(3, 10)], (256,) * 8 + (4,),
                        ('relu',) * 8 + (None,), (4,))
    p = [(torch.from_numpy(w), torch.from_numpy(b))
         for w, b in make_params(plan, seed=41)]
    x = torch.from_numpy(chain_inputs(plan, n=40, seed=42))
    dy = torch.from_numpy(np.random.RandomState(43).uniform(
        -1, 1, (40, 4)).astype(np.float32))
    y, want = plain_grads(plan, x, dy, p, None)
    np.testing.assert_allclose(fm.chain_kernel(plan, x, p).numpy(),
                               y.numpy(), **TOL['f32'])
    _, dparams = fm.chain_kernel_bwd(plan, x, dy, p, needs_dx=False)
    for g, w in zip([t for pair in dparams for t in pair], want[1:]):
        assert rel_norm(g, w) <= 1e-5


# ------ readings ------

def readings(seeds=(30, 130, 230), sizes=(50, 130, 700)):
    """Per chain, mode and size, the worst over ``seeds`` of: K1-fwd's max
    error; K1-bwd's dx and dW/db relative norms against the plain version
    and against the Pallas kernel (for bf16 also the least reading of the
    f32 kernel against the bf16 Pallas kernel); K2-bwd's worst per-row
    excess over GRAD_TOL's rtol."""
    out = []
    for name in sorted(PLANS):
        for mode in ('f32', 'bf16'):
            td = DTYPES[mode][1]
            for n in sizes:
                r = {'chain': name, 'mode': mode, 'n': n, 'fwd': 0.0,
                     'dx_vs_plain': 0.0, 'dw_vs_plain': 0.0,
                     'dx_vs_pallas': 0.0, 'dw_vs_pallas': 0.0}
                if mode == 'bf16':
                    r.update(f32_kernel_dx_vs_pallas=np.inf,
                             f32_kernel_dw_vs_pallas=np.inf)
                for seed in seeds:
                    plan, p, x, dy = chain_case(name, n, seed)
                    y, want = plain_grads(plan, x, dy, p, td)
                    pallas = pallas_grads(name, n, seed, mode)
                    r['fwd'] = max(r['fwd'], float(
                        (fm.chain_kernel(plan, x, p, td) - y).abs().max()))
                    got = kernel_grads(plan, x, dy, p, td)
                    for ref, tag in ((want, 'plain'), (pallas, 'pallas')):
                        dx, dw = grad_errs(got, ref)
                        r['dx_vs_' + tag] = max(r['dx_vs_' + tag], dx)
                        r['dw_vs_' + tag] = max(r['dw_vs_' + tag], dw)
                    if mode == 'bf16':
                        dx, dw = grad_errs(kernel_grads(plan, x, dy, p, None),
                                           pallas)
                        r['f32_kernel_dx_vs_pallas'] = min(
                            r['f32_kernel_dx_vs_pallas'], dx)
                        r['f32_kernel_dw_vs_pallas'] = min(
                            r['f32_kernel_dw_vs_pallas'], dw)
                out.append(r)
    for mode in ('f32', 'bf16'):
        td, rtol = DTYPES[mode][1], GRAD_TOL[mode]['rtol']
        worst = 0.0
        for seed in seeds:
            _, _, plan, p = both(RUSINK_PLAN, seed=seed)
            z, a, b = (torch.from_numpy(v) for v in rusink_case(seed=seed + 1))
            dy = torch.from_numpy(np.random.RandomState(seed + 2).uniform(
                -1, 1, (z.shape[0], 1)).astype(np.float32))
            ins = [t.clone().requires_grad_() for t in (z, a, b)]
            want = torch.autograd.grad(fr.reference(plan, *ins, p, td), ins, dy)
            got = fr.rusink_kernel_bwd(plan, z, a, b, dy, p, td)
            for g, w in zip(got, want):
                worst = max(worst, float(((g - w).abs() - rtol * w.abs())[
                    :-3].max()))
        out.append({'chain': 'rusink', 'mode': mode, 'rtol': rtol,
                    'atol_needed': worst})
    return out


def tc_readings(seeds=(30, 130, 230), sizes=(50, 130)):
    """Per chain of CHAIN_PLANS and size, over ``seeds``: the worst dW/db
    leaf of bf16 K1-bwd with dW only (the tensor-core design) against the
    CUDA-core bf16 kernel and against the Pallas kernel in interpret mode,
    and the least reading of the f32 kernel against the Pallas kernel."""
    out = []
    for name in sorted(CHAIN_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n, 'tc_vs_cuda_core': 0.0,
                 'tc_vs_pallas': 0.0, 'f32_kernel_vs_pallas': np.inf}
            for seed in seeds:
                plan, p, x, dy = chain_case(name, n, seed)
                got = tc_dparams(plan, x, dy, p)
                pallas = pallas_grads(name, n, seed, 'bf16')[1:]
                for key, ref in (
                        ('tc_vs_cuda_core', cuda_core_dparams(
                            plan, x, dy, p, torch.bfloat16)),
                        ('tc_vs_pallas', pallas)):
                    r[key] = max(r[key], max(
                        rel_norm(g, w) for g, w in zip(got, ref)))
                r['f32_kernel_vs_pallas'] = min(
                    r['f32_kernel_vs_pallas'], max(rel_norm(g, w) for g, w in
                                                   zip(cuda_core_dparams(
                                                       plan, x, dy, p, None),
                                                       pallas)))
            out.append(r)
    return out


def fwd_readings(seeds=(30, 130), sizes=(1, 50, 130),
                 nerf_cases=(('w32', 1), ('w32', 50), ('w32', 130),
                             ('w256', 70), ('w272', 70))):
    """Per chain of CHAIN_PLANS and size, and per K3 case, over ``seeds``:
    the worst relative norm of the bf16 tensor-core forward's output
    against the CUDA-core bf16 kernel, the Pallas kernel in interpret mode
    and the plain bf16 version, and the least reading of the f32 kernel
    (the control) against the CUDA-core bf16 kernel."""
    bf16, out = torch.bfloat16, []

    def reading(r, got, refs, f32):
        for key, ref in refs.items():
            r['tc_vs_' + key] = max(r.get('tc_vs_' + key, 0.0),
                                    rel_norm(got, ref))
        r['f32_kernel_vs_cuda_core'] = min(
            r.get('f32_kernel_vs_cuda_core', np.inf),
            rel_norm(f32, refs['cuda_core']))
    for name in sorted(CHAIN_PLANS):
        for n in sizes:
            r = {'chain': name, 'n': n}
            for seed in seeds:
                plan, p, x, _ = chain_case(name, n, seed)
                reading(r, fm.chain_kernel(plan, x, p, bf16), {
                    'cuda_core': fm.chain_kernel_cuda_core(plan, x, p, bf16),
                    'pallas': pallas_chain_fwd(name, n, seed),
                    'plain': fm.chain_reference(plan, x, p, bf16)},
                    fm.chain_kernel_cuda_core(plan, x, p, None))
            out.append(r)
    for name, n in nerf_cases:
        r = {'nerf': name, 'n': n}
        for seed in seeds:
            nplan = fn.make_nerf_plan(**NERF_FWD_PLANS[name])
            p = field_params(nplan, seed)
            pts, views = (torch.from_numpy(a)
                          for a in field_inputs(n, seed + 1)[:2])
            tp = torch_params(p)

            def field(f, cd):
                return torch.cat(f(nplan, pts, views, tp, cd), dim=1)
            reading(r, field(fn.nerf_kernel, bf16), {
                'cuda_core': field(fn.nerf_kernel_cuda_core, bf16),
                'pallas': pallas_field_fwd(name, p, pts, views),
                'plain': field(fn.nerf_reference, bf16)},
                field(fn.nerf_kernel_cuda_core, None))
        out.append(r)
    return out


def nerf_readings(seeds=(20, 21), cases=(('w32', 130), ('w256', 70),
                                         ('w272', 70))):
    """Per K3 case, over ``seeds``: the worst dW/db relative norm of the
    bf16 kernel against the Pallas kernel in interpret mode, and of the
    f32 kernel against it (the least over seeds of its worst leaf)."""
    out = []
    for name, n in cases:
        r = {'nerf': name, 'n': n, 'bf16_vs_pallas': 0.0,
             'f32_kernel_vs_pallas': np.inf}
        for seed in seeds:
            nplan, p, ins = nerf_case(name, n, seed)
            want = [torch.tensor(w) for w in jax_field(
                pn.make_nerf_plan(**NERF_PLANS[name]), p,
                *[a.numpy() for a in ins], jnp.bfloat16, True)[2]]
            for td, key, agg in ((torch.bfloat16, 'bf16_vs_pallas', max),
                                 (None, 'f32_kernel_vs_pallas', min)):
                worst = max(rel_norm(g, w) for g, w in zip(
                    nerf_kernel_grads(nplan, ins, p, td), want))
                r[key] = agg(r[key], worst)
        out.append(r)
    return out


def k3_bits(seed=20, cases=(('w32', 130), ('w256', 70), ('w272', 70))):
    """Per K3 case, a digest of bf16 K3-bwd's dW/db bits and of the dW
    pass's alone (on dw_scratch's values): the same digest from two source
    trees means the same bits."""
    out = []
    for name, n in cases:
        nplan, p, ins = nerf_case(name, n, seed)
        grads = nerf_kernel_grads(nplan, ins, p, torch.bfloat16)
        tab, tile = fn.dw_table(nplan, CPU)
        dw = fm.dw_pass(tab, tile, dw_scratch(tab, n, seed), n)
        out.append({'nerf': name, 'n': n, 'seed': seed,
                    'dw_db_sha256': hashlib.sha256(b''.join(
                        g.numpy().tobytes() for g in grads)).hexdigest(),
                    'dw_pass_sha256': hashlib.sha256(
                        dw.numpy().tobytes()).hexdigest()})
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--csrc', default=kernel_lib.CSRC_DIR,
                        help="directory of the kernel sources to emulate")
    parser.add_argument('--k3_bits', action='store_true',
                        help="print only the digests of k3_bits")
    args = parser.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        with emulation(build(args.csrc, tmp)):
            rows = k3_bits() if args.k3_bits else \
                readings() + tc_readings() + nerf_readings() + \
                fwd_readings()
            for r in rows:
                print(json.dumps(r))


if __name__ == '__main__':
    main()
