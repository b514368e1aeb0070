"""Kernel P on the warpgroup product (``csrc/dot_probe.cu``) and its
building blocks (``csrc/wgmma.cuh``), run on the CPU through the g++
emulation of the CUDA subset (``nerfactor_tpu_torch/csrc/emu``).

Only ``dot_probe.cu`` and the headers it includes are compiled, into the
test's temporary directory, with ``tests/test_torch_emu.py``'s ``build``.
The emulated wgmma runs asynchronously as the card's does (a product runs
at the wait that completes its group) and decodes each shared-memory
descriptor and its swizzle itself, so a layout, descriptor, ring or
ordering fault of the kernel shows here before a card call:

* the building blocks: m64n128k16 with A from registers and from shared
  memory against a float64 product of the same bf16 values; descriptors
  with the wrong swizzle or stride byte offset must break that check;
* kernel P, every mode, at 300 rows (two blocks of 256, and one block of
  512 that walks two chunks) against the plain version and the TPU
  probe's chain written in JAX, within ``dp.TOL``;
* a depth longer than the weight ring, so that every stage is refilled.

``JAX_PLATFORMS=cpu python -m tests.test_torch_emu_wgmma`` prints the
readings.
"""

import contextlib
import ctypes
import json
import os
import shutil

import numpy as np
import pytest
import torch

from nerfactor_tpu_torch.ops import dot_probe as dp
from nerfactor_tpu_torch.ops import kernel_lib
from tests.test_torch_chain import rel_norm
from tests.test_torch_chain_routes import jax_dot_chain
from tests.test_torch_emu import build

# The emulated kernel's sources: kernel P and the headers it includes
SOURCES = ('dot_probe.cu', 'wgmma.cuh', 'chain_mlp.cuh')
# The building block against float64: f32 accumulation over K = 128 of
# products of values in [-1, 1]
TILE_TOL = 1e-4
ROWS = 300


def emulated_library(out_dir):
    """Compiles SOURCES' emulation into ``out_dir``; returns its path."""
    src = os.path.join(out_dir, 'src')
    os.makedirs(src)
    for name in SOURCES:
        shutil.copy(os.path.join(kernel_lib.CSRC_DIR, name), src)
    return build(src, out_dir)


def _run_on_cpu(entry, device, *args):
    kernel_lib.check(kernel_lib.entry(entry)(*args, None), entry)


@contextlib.contextmanager
def emulation(lib_path):
    """Within: dot_probe's wrappers launch the emulated library on CPU
    tensors."""
    saved = (kernel_lib.build, kernel_lib._lib, dp._require_cuda, dp._run)
    kernel_lib.build = lambda: lib_path
    kernel_lib._lib = ctypes.CDLL(lib_path)
    dp._require_cuda, dp._run = (lambda t, what: None), _run_on_cpu
    try:
        yield
    finally:
        (kernel_lib.build, kernel_lib._lib, dp._require_cuda,
         dp._run) = saved


@pytest.fixture(scope='module')
def emulated_lib(tmp_path_factory):
    if shutil.which('g++') is None:
        pytest.skip("needs g++ to compile the emulation of the CUDA sources")
    return emulated_library(str(tmp_path_factory.mktemp('emu')))


@pytest.fixture
def emulated(emulated_lib):
    with emulation(emulated_lib):
        yield


def tile_case(seed):
    rng = np.random.RandomState(seed)
    a, w = (torch.from_numpy(rng.uniform(-1, 1, shape).astype(np.float32))
            .to(torch.bfloat16) for shape in ((64, 128), (128, 128)))
    return a, w


def tile_err(a, w, **desc):
    got = dp.wgmma_tile(a, w, **desc).double()
    want = dp.wgmma_tile_reference(a, w)
    return ((got - want).abs() / (TILE_TOL + TILE_TOL * want.abs())).max().item()


@pytest.mark.parametrize('ss', [False, True], ids=['rs', 'ss'])
def test_wgmma_tile_matches_float64(ss, emulated):
    """m64n128k16 over eight k16 steps, B (and A) through 128-byte-swizzled
    descriptors, within TILE_TOL (abs + rel) of float64."""
    a, w = tile_case(60 + ss)
    assert tile_err(a, w, ss=ss) <= 1


# Descriptors that misread the swizzled operand: another swizzle's width,
# none, or the 8-row groups' stride halved
BAD_DESCS = {'swizzle64': dict(layout=dp.SWIZZLE_64),
             'interleave': dict(layout=dp.INTERLEAVE),
             'sbo512': dict(sbo=dp.SWIZZLE_ATOM // 2)}


@pytest.mark.parametrize('ss', [False, True], ids=['rs', 'ss'])
@pytest.mark.parametrize('bad', sorted(BAD_DESCS))
def test_wrong_descriptor_breaks_the_tile_check(bad, ss, emulated):
    """The emulation reads the layout the descriptor names, not a copy of
    the operand: a wrong swizzle or stride fails the float64 check."""
    a, w = tile_case(62)
    assert tile_err(a, w, ss=ss, **BAD_DESCS[bad]) > 1


def chain_inputs(depth, seed, rows=ROWS):
    """x 0.1 randn (rows, 128), orthonormal bf16 weights (the probe
    tool's), from ``seed``."""
    rng = np.random.RandomState(seed)
    x = (0.1 * rng.randn(rows, dp.WIDTH)).astype(np.float32)
    ws = np.stack([np.linalg.qr(rng.randn(dp.WIDTH, dp.WIDTH))[0]
                   for _ in range(depth)])
    return torch.from_numpy(x), torch.from_numpy(ws).to(torch.bfloat16)


def readings(mode, depth, block, seed):
    """The emulated kernel against the plain version and the JAX chain:
    relative norms, and the share of outputs bit-equal to the plain
    version (its f32 sums run in another order than the tensor cores'
    k16 steps, so a bf16 rounding may differ)."""
    x, ws = chain_inputs(depth, seed)
    launches = dp.dot_chain_kernel.launches
    got = dp.dot_chain_kernel(x, ws, mode, block=block)
    assert dp.dot_chain_kernel.launches == launches + 1
    plain = dp.dot_chain_reference(x, ws, mode)
    jax_out = torch.from_numpy(jax_dot_chain(
        x.numpy().T, ws.float().numpy(), mode).T.copy())
    return {'mode': mode, 'depth': depth, 'rows': ROWS, 'block': block,
            'finite': bool(torch.isfinite(got).all()),
            'vs_plain': rel_norm(got, plain), 'vs_jax': rel_norm(got, jax_out),
            'bit_equal_to_plain': (got == plain).float().mean().item(),
            'tol': dp.TOL[mode]}


def check(r):
    print(json.dumps(r))
    assert r['finite']
    assert r['vs_plain'] <= r['tol'] and r['vs_jax'] <= r['tol'], r


@pytest.mark.parametrize('depth', [2, 4])
@pytest.mark.parametrize('mode', dp.MODES)
def test_emulated_dot_chain(mode, depth, emulated):
    """Every mode at 300 rows in blocks of 256 (two blocks, a ragged end)
    against the plain version and the JAX chain within dp.TOL."""
    check(readings(mode, depth, 256, seed=70 + depth))


@pytest.mark.parametrize('mode', dp.MODES)
def test_emulated_dot_chain_walks_chunks(mode, emulated):
    """One block of 512 rows over 300: serial and indep walk two chunks of
    256 (pair three of 128), the ring running on from one to the next."""
    assert -(-ROWS // dp.CHUNK_ROWS[mode]) >= 2
    check(readings(mode, 4, 512, seed=75))


@pytest.mark.parametrize('mode', dp.MODES)
def test_emulated_dot_chain_refills_the_ring(mode, emulated):
    """A depth past the ring's stages (7 for serial and indep against 6
    stages; 8 for pair against 3), so every stage is refilled."""
    check(readings(mode, dp.ring_refill_depth(mode), 256, seed=76))


@pytest.mark.parametrize('mode', dp.MODES)
def test_plan_constants_match_the_kernel(mode, emulated):
    """ops/dot_probe.py's ring and chunk sizes, from which the tests take
    their depths and row counts, are the kernel's own."""
    assert dp.plan(mode) == (dp.RING_MATS, dp.STAGE_MATS[mode],
                             dp.CHUNK_ROWS[mode])
    stages = dp.RING_MATS // dp.STAGE_MATS[mode]
    assert dp.ring_refill_depth(mode) // dp.STAGE_MATS[mode] == stages + 1


def test_emulated_dot_chain_takes_no_rows_and_refuses_bad_blocks(emulated):
    x, ws = chain_inputs(2, seed=77, rows=0)
    launches = dp.dot_chain_kernel.launches
    assert dp.dot_chain_kernel(x, ws, 'serial').shape == (0, dp.WIDTH)
    assert dp.dot_chain_kernel.launches == launches
    x, ws = chain_inputs(2, seed=77)
    with pytest.raises(ValueError, match='multiple of 256'):
        dp.dot_chain_kernel(x, ws, 'serial', block=384)
    with pytest.raises(ValueError, match='even'):
        dp.dot_chain_kernel(x, ws[:1], 'pair')


def test_the_wrappers_need_the_card():
    x, ws = chain_inputs(2, seed=78)
    for fn in (dp.dot_chain_kernel, dp._dot_chain_mma):
        with pytest.raises(ValueError, match='CUDA'):
            fn(x, ws, 'serial')
    with pytest.raises(ValueError, match='CUDA'):
        dp.wgmma_tile(*tile_case(60))


def main():
    import tempfile
    with tempfile.TemporaryDirectory() as d, emulation(emulated_library(d)):
        for ss in (False, True):
            a, w = tile_case(60 + ss)
            print(json.dumps({'tile': 'ss' if ss else 'rs',
                              'err_over_tol': tile_err(a, w, ss=ss),
                              'controls': {k: tile_err(a, w, ss=ss, **v)
                                           for k, v in BAD_DESCS.items()}}))
        for mode in dp.MODES:
            for depth in (2, 4):
                print(json.dumps(readings(mode, depth, 256, 70 + depth)))
            print(json.dumps(readings(mode, 4, 512, 75)))
            print(json.dumps(readings(mode, dp.ring_refill_depth(mode),
                                      256, 76)))


if __name__ == '__main__':
    main()
