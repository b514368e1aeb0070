"""K1's f32 backward with dW on the tensor cores in split TF32 (phase 1
``chain_bwd_f32_tc_kernel``, the dW pass ``dw_f32_kernel``; each f32
operand split into TF32 hi and lo, each product lo hi + hi lo + hi hi on
mma.sync m16n8k8) and the packing kernel ``nfk_pack_transposed``, on the
CPU through the g++ emulation of the CUDA sources (``test_torch_emu``),
against the JAX Pallas kernel ``_pallas_backward_trig_t`` in f32 in
interpret mode (``needs_dw=True``, ``needs_dx=False``) and float64.

The plans: the shape model's normal chain (xyz posenc at 10 octaves, 128 x
4 with the embedding concatenated after layer 2, a 3-wide linear head)
narrowed to 4 x 32, and the microfacet model's roughness head (the same
trunk, a 1-wide sigmoid head), at 130 rows (two tiles and a ragged edge).
The limit is DW_TOL_F32 (1e-4 by relative norm), the smoke's for the f32
heads' dW/db; plain TF32 (hi hi alone, ``terms`` 1), the control, must
break it.

  JAX_PLATFORMS=cpu python -m tests.test_torch_f32_dw_tc

prints the readings (the kernel's, the control's and the Pallas kernel's
own against float64).
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

# shape.ini's normal chain and nerfactor_microfacet.ini's roughness head,
# narrowed
TRUNK = dict(embed=[(3, 10)], widths=(32,) * 4, acts=('relu',) * 4,
             skip=(2,))
PLANS = {
    'normal': (TRUNK['embed'], TRUNK['widths'] + (3,),
               TRUNK['acts'] + (None,), TRUNK['skip']),
    'roughness': (TRUNK['embed'], TRUNK['widths'] + (1,),
                  TRUNK['acts'] + ('sigmoid',), TRUNK['skip']),
}
ROWS = 130
SEED = 41
# chip_smoke.DW_TOL_F32: the f32 heads' dW/db, relative norm
DW_TOL_F32 = 1e-4


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


def flat(pairs):
    return [t for pair in pairs for t in pair]


@functools.lru_cache(maxsize=None)
def case(name, n=ROWS, seed=SEED):
    """The JAX and torch plans and params, x (n, 3) and a head cotangent dy
    from numpy draws; with the Pallas kernel's dW/db (interpret mode, f32,
    needs_dx=False) and the plain version's in float64."""
    jplan, jp, plan, p = both(PLANS[name], seed=seed)
    x = chain_inputs(plan, n=n, seed=seed + 1)
    dy = np.random.RandomState(seed + 2).uniform(
        -1, 1, (n, plan.widths[-1])).astype(np.float32)
    pm.INTERPRET = True
    try:
        _, vjp = jax.vjp(lambda p_: pm.apply_chain(jplan, jnp.asarray(x), p_,
                                                   needs_dx=False), jp)
        gp, = vjp(jnp.asarray(dy))
    finally:
        pm.INTERPRET = False
    pallas = [np.asarray(t) for pair in gp for t in pair]
    leaves = [t.double().clone().requires_grad_() for t in flat(p)]
    y = fm.chain_reference(plan, torch.from_numpy(x).double(),
                           list(zip(leaves[0::2], leaves[1::2])))
    f64 = [g.numpy() for g in torch.autograd.grad(
        y, leaves, torch.from_numpy(dy).double())]
    return plan, p, torch.from_numpy(x), torch.from_numpy(dy), pallas, f64


def worst(got, want):
    return max(rel_norm(g, w) for g, w in zip(got, want))


def kernel_dw(plan, p, x, dy, terms=3, scratch=None):
    return [t.numpy() for t in flat(fm.chain_kernel_bwd_dw_f32_tc(
        plan, x, dy, p, terms, scratch=scratch))]


@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_f32_dw_matches_interpreted_pallas_kernel(name, emulated):
    """dW/db of every layer within DW_TOL_F32 by relative norm of the
    Pallas kernel's in interpret mode and of the plain version's in
    float64 (the reading printed); bit-identical across two launches."""
    plan, p, x, dy, pallas, f64 = case(name)
    got = kernel_dw(plan, p, x, dy)
    print('%s: vs Pallas %.3g, vs float64 %.3g (Pallas vs float64 %.3g)'
          % (name, worst(got, pallas), worst(got, f64), worst(pallas, f64)))
    assert worst(got, pallas) <= DW_TOL_F32
    assert worst(got, f64) <= DW_TOL_F32
    again = kernel_dw(plan, p, x, dy)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize('name', sorted(PLANS))
def test_emulated_tf32_control_breaks_the_dw_limit(name, emulated):
    """Plain TF32 (hi hi alone, in phase 1 and the dW pass) is no f32
    design: its dW/db part from the Pallas kernel's by more than
    DW_TOL_F32."""
    plan, p, x, dy, pallas, _ = case(name)
    assert worst(kernel_dw(plan, p, x, dy, terms=1), pallas) > DW_TOL_F32


def forward_posts(plan, p, x, layer):
    """Hidden layer ``layer``'s posts as the split-TF32 forward tile
    computes them (chain_fwd_f32_tc_kernel): the chain cut after that
    layer, with a linear head of 8 columns whose weights pick 8 of its
    units (a 1 each, the rest 0, zero bias), so each output is one post,
    bit for bit (a sum of exact zeros and the post itself)."""
    sub = plan._replace(widths=plan.widths[:layer + 1] + (8,),
                        acts=plan.acts[:layer + 1] + (None,),
                        skip_at=tuple(s for s in plan.skip_at if s < layer))
    width, cols = plan.widths[layer], []
    for c0 in range(0, width, 8):
        pick = torch.zeros(width, 8)
        pick[torch.arange(c0, c0 + 8), torch.arange(8)] = 1.0
        cols.append(fm.chain_kernel_f32_tc(
            sub, x, p[:layer + 1] + [(pick, torch.zeros(8))]))
    return torch.cat(cols, dim=1)


def test_emulated_phase1_posts_are_the_forward_tiles(emulated):
    """The posts that phase 1 writes to its scratch (every hidden layer's
    that feeds a later one) equal, bit for bit, the split-TF32 forward
    tile's on the same rows: the recompute is the forward's own loop at
    the forward's policy, so each ReLU gates alike in the output and in
    the gradient."""
    plan, p, x, dy, _, _ = case('normal')
    scratch = []
    kernel_dw(plan, p, x, dy, scratch=scratch)
    tab, _ = fm.chain_dw_table(fm.mma_plan(plan), x.device)
    rows = scratch[0].view(-1, tab.total)[:x.shape[0]]
    for layer in range(len(plan.widths) - 2):
        col = tab.layers[layer + 1].seg1
        got = rows[:, col:col + plan.widths[layer]]
        want = forward_posts(plan, p, x, layer)
        assert torch.equal(got, want), layer
        assert (got > 0).any() and (got == 0).any()


PACK_PLANS = {
    'normal': PLANS['normal'],
    'lvis': ([(3, 4), (3, 2)], (32,) * 4 + (1,), ('relu',) * 4 + ('sigmoid',),
             (2,)),
    'w24': ([(3, 3)], (24,) * 3 + (2,), ('relu',) * 3 + (None,), (1,)),
}


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('name', sorted(PACK_PLANS))
def test_emulated_pack_transposed_kernel_matches_plain(name, dtype,
                                                       emulated):
    """nfk_pack_transposed (one launch) writes pack_transposed's buffer bit
    for bit, in f32 and bf16, on plans with a skip consumer, two embedding
    parts and widths padded to the mma step (24 -> 32)."""
    _, _, plan, p = both(PACK_PLANS[name], seed=7)
    kplan = fm.mma_plan(plan)
    kp = fm.pad_params(plan, p) if kplan != plan else p
    w_flat, _ = fm.pack_params(kplan, kp, dtype)
    tab, _ = fm.chain_dw_table(kplan, torch.device('cpu'))
    want = fm.pack_transposed([w for w, _ in kp[:-1]], tab, dtype)
    before = fm.pack_transposed_kernel.launches
    got, calls = calls_of(lambda: fm.pack_transposed_kernel(kplan, w_flat))
    assert calls == ['nfk_pack_transposed']
    assert fm.pack_transposed_kernel.launches == before + 1
    assert got.dtype == dtype and got.shape == want.shape
    bits = torch.int32 if dtype == torch.float32 else torch.int16
    assert torch.equal(got.view(bits), want.view(bits))


def kernel_apply_chain(plan, x, params, needs_dx, needs_dw,
                       stash_route=False):
    """The route's kernels under autograd, as apply_chain runs them on a
    CUDA tensor, on CPU tensors for the emulation."""
    return fm.ChainFunction.apply(plan, None, needs_dx, needs_dw,
                                  stash_route, x, *flat(params))


def test_emulated_f32_dw_rules(emulated, monkeypatch):
    """Under autograd, an f32 chain with dW alone on K1's route runs the
    split-TF32 forward whatever its rows (130, below F32_TC_MIN_ROWS) and
    the split-TF32 backward with dW over the transposed weights the forward
    packed (once a step), each counted on its own counter, with the dW/db
    of chain_kernel_bwd's launch (one ``nfk_chain_bwd_dw_tc_f32``: phase 1
    and the dW pass), which packs its own. f32 with dW and dx, f32 on the
    stash route (K1r), f32 with a skip after the head (K1w), a non-ReLU
    hidden layer and dW past F32_DW_TC_MAX_ROWS rows keep the CUDA-core
    kernels."""
    plan, p, x, dy, _, _ = case('normal')
    packs, pack = [], fm.transposed_weights

    def counted(*args):
        packs.append(pack(*args))
        return packs[-1]
    monkeypatch.setattr(fm, 'transposed_weights', counted)
    before = (fm.chain_kernel.f32_tc_launches,
              fm.chain_kernel_bwd.dw_tc_f32_launches,
              fm.chain_kernel_bwd.dx_tc_launches)
    leaves = [t.clone().requires_grad_() for t in flat(p)]
    pairs = list(zip(leaves[0::2], leaves[1::2]))
    y, calls = calls_of(lambda: kernel_apply_chain(plan, x, pairs, False,
                                                   True))
    assert 'nfk_chain_fwd_tc_f32' in calls and 'nfk_chain_fwd' not in calls
    grads, calls = calls_of(lambda: torch.autograd.grad(y, leaves, dy))
    assert calls[-1] == 'nfk_chain_bwd_dw_tc_f32' \
        and 'nfk_chain_bwd' not in calls
    assert len(packs) == 1 and packs[0] is y.grad_fn.wt
    assert (fm.chain_kernel.f32_tc_launches,
            fm.chain_kernel_bwd.dw_tc_f32_launches,
            fm.chain_kernel_bwd.dx_tc_launches) == (
        before[0] + 1, before[1] + 1, before[2])
    (_, want), calls = calls_of(lambda: fm.chain_kernel_bwd(
        plan, x, dy, p, needs_dx=False))
    assert calls[-1] == 'nfk_chain_bwd_dw_tc_f32' \
        and 'nfk_chain_bwd' not in calls
    assert all(torch.equal(g, w) for g, w in zip(grads, flat(want)))
    # The calls that stay on the CUDA cores, forward and backward
    softplus = plan._replace(acts=('softplus',) + plan.acts[1:])
    last = plan._replace(skip_at=plan.skip_at + (len(plan.widths) - 1,))
    monkeypatch.setattr(fm, 'F32_DW_TC_MAX_ROWS', x.shape[0] - 1)
    for pl, needs_dx, stash_route in ((plan, True, False),
                                      (plan, False, True),
                                      (softplus, False, False),
                                      (plan, False, False)):
        xg = x.clone().requires_grad_(needs_dx)
        y, calls = calls_of(lambda: kernel_apply_chain(
            pl, xg, pairs, needs_dx, True, stash_route))
        assert 'nfk_chain_fwd' in calls and 'nfk_chain_fwd_tc_f32' not in calls
        _, calls = calls_of(lambda: torch.autograd.grad(y, leaves, dy))
        assert calls[-1] == 'nfk_chain_bwd'
    _, _, lplan, lp = both(PLANS['normal'][:3] + ((2, 4),), seed=SEED)
    ldy = torch.cat([dy, torch.zeros(x.shape[0], fm.embed_dim(lplan))], 1)
    assert fm.last_skip(lplan)
    _, calls = calls_of(lambda: fm.chain_kernel_last_skip_bwd(
        lplan, x, ldy, lp, needs_dx=False))
    assert calls[-1] == 'nfk_chain_bwd'


# ------ readings ------

def readings(seeds=(41, 42, 43)):
    """Per plan and seed: the split-TF32 design's and the control's dW/db
    against the Pallas kernel (interpret mode) and float64, the Pallas
    kernel's own against float64, by relative norm (the worst leaf)."""
    from tests.test_torch_emu import emulated_library
    import tempfile
    out = []
    with tempfile.TemporaryDirectory() as tmp, emulated_library(tmp):
        for name in sorted(PLANS):
            for seed in seeds:
                plan, p, x, dy, pallas, f64 = case(name, seed=seed)
                row = {'plan': name, 'rows': ROWS, 'seed': seed,
                       'pallas_vs_f64': worst(pallas, f64)}
                for terms in (3, 1):
                    got = kernel_dw(plan, p, x, dy, terms)
                    row['tf32x%d' % terms] = {'vs_pallas': worst(got, pallas),
                                              'vs_f64': worst(got, f64)}
                out.append(row)
    return out


if __name__ == '__main__':
    for r in readings():
        print(json.dumps(r))
