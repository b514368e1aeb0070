"""K1's f32 split-TF32 kernels on the card (the ``cuda`` marker: they skip
without one): the forward ``chain_fwd_f32_tc_kernel`` and the dx-only
backward ``chain_dx_f32_tc_kernel`` against the CUDA-core kernels they
replace and the plain f32 version (TF32 off), at 1 and 4,099 rows (the
forward also at F32_TC_MIN_ROWS, from which K1-fwd alone takes it), on
NeRF's sigma chain (narrowed, and at nerf.ini's 8 x 256), the lvis chain
and a width off the mma step; and the f32 building block alone, whose
one-product mode must give the product of the operands rounded by
cvt.rna.tf32.f32 (to nearest, ties away from zero), as the CPU emulation
does (tests/test_torch_f32_tc.py). No JAX here: the card machine's
tests compare with the plain PyTorch version.

  python -m pytest tests/test_torch_f32_tc_card.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from nerfactor_tpu_torch.ops import fused_mlp as fm

PLANS = {
    'sigma_narrow': ([(3, 10)], (64,) * 4 + (1,), ('relu',) * 4 + (None,),
                     (2,)),
    'sigma': ([(3, 10)], (256,) * 8 + (1,), ('relu',) * 8 + (None,), (4,)),
    'lvis': ([(3, 10), (3, 4)], (128,) * 4 + (1,),
             ('relu',) * 4 + ('sigmoid',), (2,)),
    'w24': ([(3, 4), (3, 2)], (24,) * 4 + (2,), ('relu',) * 4 + (None,),
            (2,)),
}
# The f32 limits of the card's other f32 K1 tests (test_torch_chain TOL and
# GRAD_TOL): forward 1e-5 + 1e-5 rel; dx 1e-4 + 1e-4 rel on the rows off
# every ReLU kink (a row whose pre-activation sits within KINK of 0 is
# gated either way by an f32 rounding), and by relative norm over all rows
# the smoke's SIGMA_DX_TOL_F32. Readings of the emulation: forward <= 3.6e-7,
# dx <= 7.3e-7 relative norm; plain TF32, the control, 3.8e-4 and 1.2e-2.
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
DX_TOL = dict(rtol=1e-4, atol=1e-4)
DX_NORM_TOL = 1e-2
KINK = 1e-4
# The split-TF32 kernels against the CUDA-core f32 ones, relative norm
VS_CUDA_CORE_TOL = 1e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def card_case(name, n, seed, device):
    """Glorot-uniform weights, 0.1-uniform biases, inputs in [-1.5, 1.5]
    and head cotangents in [-1, 1], drawn with numpy from ``seed``."""
    plan = fm.make_plan(*PLANS[name])
    rng = np.random.RandomState(seed)
    p = []
    for d, w in zip(fm.layer_in_dims(plan), plan.widths):
        lim = np.sqrt(6 / (d + w))
        p.append((torch.from_numpy(rng.uniform(-lim, lim, (d, w))
                                   .astype(np.float32)).to(device),
                  torch.from_numpy(rng.uniform(-0.1, 0.1, w)
                                   .astype(np.float32)).to(device)))
    x = torch.from_numpy(rng.uniform(-1.5, 1.5, (n, fm.raw_dim(plan)))
                         .astype(np.float32)).to(device)
    dy = torch.from_numpy(rng.uniform(-1, 1, (n, plan.widths[-1]))
                          .astype(np.float32)).to(device)
    return plan, p, x, dy


def rel_norm(got, want):
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def off_kinks(plan, x, p):
    """Rows whose pre-activations at every ReLU layer sit farther than
    KINK from 0, in float64."""
    e = fm._embed(plan, x.double())
    h, low = e, None
    for i, ((w, b), act) in enumerate(zip(p, plan.acts)):
        w, b = w.double(), b.double()
        pre = torch.cat((h, e), dim=1) @ w + b \
            if i > 0 and (i - 1) in plan.skip_at else h @ w + b
        if act == 'relu':
            m = pre.abs().min(dim=1).values
            low = m if low is None else torch.minimum(low, m)
        h = fm._act(act, pre)
    return low > KINK


def recorded_calls(monkeypatch):
    """The library entries the wrappers call from now on, in order."""
    calls, run = [], fm.run

    def record(entry, *args, **kw):
        calls.append(entry)
        return run(entry, *args, **kw)
    monkeypatch.setattr(fm, 'run', record)
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099, fm.F32_TC_MIN_ROWS])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_f32_fwd_on_card(name, n, cuda, monkeypatch):
    """f32 K1-fwd alone launches the split-TF32 entry from F32_TC_MIN_ROWS
    rows, counted once on its own counter, and the CUDA-core entry below.
    The split-TF32 kernel: within FWD_TOL of the plain f32 version, within
    VS_CUDA_CORE_TOL of the CUDA-core kernel, bit-identical across
    launches."""
    plan, p, x, _ = card_case(name, n, 70, cuda)
    calls = recorded_calls(monkeypatch)
    launches = fm.chain_kernel.f32_tc_launches
    y = fm.chain_kernel(plan, x, p)
    torch.cuda.synchronize()
    tc = n >= fm.F32_TC_MIN_ROWS
    assert ('nfk_chain_fwd_tc_f32' in calls) == tc \
        and ('nfk_chain_fwd' in calls) != tc
    assert fm.chain_kernel.f32_tc_launches == launches + tc
    got = fm.chain_kernel_f32_tc(plan, x, p)
    assert torch.equal(y, got) or not tc
    np.testing.assert_allclose(got.cpu().numpy(),
                               fm.chain_reference(plan, x, p).cpu().numpy(),
                               **FWD_TOL)
    assert rel_norm(got, fm.chain_kernel_cuda_core(plan, x, p)) \
        <= VS_CUDA_CORE_TOL
    assert torch.equal(got, fm.chain_kernel_f32_tc(plan, x, p))


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 4099])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_f32_dx_only_on_card(name, n, cuda, monkeypatch):
    """f32 K1-bwd with dx alone launches the split-TF32 entry alone (no
    dW, counted once on its own counter): within DX_TOL of autograd of the
    plain f32 version off the ReLU kinks and DX_NORM_TOL over all rows,
    within VS_CUDA_CORE_TOL of the CUDA-core kernel, bit-identical across
    launches."""
    plan, p, x, dy = card_case(name, n, 71, cuda)
    calls = recorded_calls(monkeypatch)
    launches = fm.chain_kernel_bwd.dx_tc_launches
    got, dparams = fm.chain_kernel_bwd(plan, x, dy, p, needs_dw=False)
    torch.cuda.synchronize()
    assert calls[-1] == 'nfk_chain_bwd_dx_tc_f32' \
        and 'nfk_chain_bwd' not in calls and dparams is None
    assert fm.chain_kernel_bwd.dx_tc_launches == launches + 1
    xg = x.clone().requires_grad_()
    want, = torch.autograd.grad(fm.chain_reference(plan, xg, p), xg, dy)
    keep = off_kinks(plan, x, p)
    np.testing.assert_allclose(got[keep].cpu().numpy(),
                               want[keep].cpu().numpy(), **DX_TOL)
    assert rel_norm(got, want) <= DX_NORM_TOL
    core, _ = fm.chain_kernel_bwd_cuda_core(plan, x, dy, p, needs_dw=False)
    assert rel_norm(got[keep], core[keep]) <= VS_CUDA_CORE_TOL
    assert torch.equal(got, fm.chain_kernel_bwd(plan, x, dy, p,
                                                needs_dw=False)[0])


def tf32_rna(a):
    """cvt.rna.tf32.f32 in numpy (finite values)."""
    u = np.asarray(a, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


@pytest.mark.cuda
@pytest.mark.parametrize('m,n,k', [(1, 8, 8), (37, 20, 45), (130, 300, 33)])
def test_tf32_products_on_card(m, n, k, cuda):
    """The f32 building block on the card: one product gives the product
    of the operands rounded to nearest, ties away (a third of them exact
    ties), within 1e-5 + 1e-5 rel (the tensor cores' own accumulation; a
    tie rounded the other way moves a product by ~2.5e-4); three the f32
    operands' product within 1e-5 + 1e-5 rel."""
    rng = np.random.RandomState(m + n + k)

    def draw(shape):
        v = rng.uniform(-1, 1, shape).astype(np.float32)
        u = v.view(np.uint32)
        ties = rng.uniform(size=shape) < 1 / 3
        u[ties] = (u[ties] & np.uint32(0xffffe000)) | np.uint32(0x1000)
        return u.view(np.float32)
    a, b = draw((m, k)), draw((n, k))
    ta, tb = torch.from_numpy(a).to(cuda), torch.from_numpy(b).to(cuda)
    got1 = fm.tc_matmul_f32(ta, tb, 1).cpu().numpy()
    got3 = fm.tc_matmul_f32(ta, tb, 3).cpu().numpy()
    want1 = tf32_rna(a).astype(np.float64) @ tf32_rna(b).astype(np.float64).T
    want3 = a.astype(np.float64) @ b.astype(np.float64).T
    np.testing.assert_allclose(got1, want1, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got3, want3, rtol=1e-5, atol=1e-5)
