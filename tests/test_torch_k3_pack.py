"""K3's transposed dense weights packed on the card in one launch
(``nfk_pack_transposed_table``, ``csrc/pack_transposed.cu``, through
``fused_nerf.transposed_weights``), on the CPU through the g++ emulation of
the CUDA sources (``test_torch_emu``), against its plain version
``fused_nerf.transposed_weights_plain`` (``fused_mlp.pack_transposed``
over the table of ``nfk_nerf_dw_table``): the same bits, in bf16 (what
K3's tensor-core kernels read) and f32, on the emulation tests' field
plans: nerf.ini's 8 x 256 trunk with its skip, a narrow one, one past a
256-wide column pass and one off the mma step (24 -> 32, rgb 8 -> 16).
"""

import pytest
import torch

from nerfactor_tpu_torch.ops import fused_nerf as fn
from tests.test_torch_emu import NERF_PLAN_W24, NERF_PLANS
from tests.test_torch_nerf import field_params, torch_params

PLANS = {'w32': NERF_PLANS['w32'], 'w24': NERF_PLAN_W24,
         'w256': NERF_PLANS['w256']}
CASES = [(name, dtype) for name in sorted(PLANS)
         for dtype in (torch.bfloat16, torch.float32)
         if name != 'w256' or dtype == torch.bfloat16]


@pytest.fixture(scope='module')
def emulated(tmp_path_factory):
    from tests.test_torch_emu import emulated_library
    with emulated_library(str(tmp_path_factory.mktemp('emu'))):
        yield


def packed(name, dtype):
    """(kplan, K3's padded params, their packed dense weights at dtype)."""
    nplan = fn.make_nerf_plan(**PLANS[name])
    kplan, params = fn._mma_params(
        nplan, torch_params(field_params(nplan, seed=11)))
    dense, _ = fn.pack_params(kplan, params, dtype)
    return kplan, params, dense


@pytest.mark.parametrize('name,dtype', CASES)
def test_emulated_k3_pack_matches_plain(name, dtype, emulated):
    from tests.test_torch_emu import CALLS
    kplan, params, dense = packed(name, dtype)
    want = fn.transposed_weights_plain(kplan, params, torch.device('cpu'),
                                       dtype)
    before = fn.transposed_weights.launches
    del CALLS[:]
    got = fn.transposed_weights(kplan, dense)
    assert CALLS == ['nfk_pack_transposed_table']
    assert fn.transposed_weights.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))


def test_emulated_k3_wrappers_pack_once_a_step(emulated):
    """bf16 K3-fwd packs W^T in one launch of the kernel and K3-bwd under
    autograd reads that buffer: one pack a forward and backward."""
    from tests.test_torch_emu import CALLS
    from tests.test_torch_emu import nerf_case
    nplan, p, ins = nerf_case('w32', 16, seed=3)
    leaves = [t.clone().requires_grad_()
              for t in fn.flatten(torch_params(p))]
    del CALLS[:]
    rgb, sigma = fn.NerfFunction.apply(nplan, torch.bfloat16, *ins[:2],
                                       *leaves)
    torch.autograd.grad(rgb.sum() + sigma.sum(), leaves)
    assert CALLS.count('nfk_pack_transposed_table') == 1
    assert 'nfk_nerf_fwd_tc' in CALLS and 'nfk_nerf_bwd' in CALLS
