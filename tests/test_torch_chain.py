"""The port's fused chains vs the JAX package's (CPU).

K1 (embed -> skip-MLP -> head) and K2 (dir2rusink -> frozen BRDF chain):
the port's plain versions (what ``apply_chain`` / ``apply_rusink_chain``
run on CPU tensors) against the JAX reference programs and against the
JAX Pallas kernels run through the Pallas interpreter, in true f32 and
in bf16-operand mode, forward and gradients. The CUDA kernels themselves
run only on a card: those tests carry the ``cuda`` marker and skip here.

Tolerances: f32 1e-5 (summation order, transcendental kernels); bf16
1e-2 (bf16 rounds activations at other places in the kernels). Gradients:
f32 1e-4 (the TPU kernels' double-angle trig errs ~2^f ulp at octave f,
as the JAX package's own gradient test allows); bf16 rtol 0.1, atol 0.05
(the JAX package's own bf16 bound: the plain version rounds every
cotangent to bf16 at each cast, the kernels round only d_pre)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.ops import pallas_mlp as pm
from nerfactor_tpu.ops import pallas_rusink as pr
from nerfactor_tpu_torch.ops import fused_mlp as fm
from nerfactor_tpu_torch.ops import fused_rusink as fr
from nerfactor_tpu_torch.ops import kernel_lib

TOL = {'f32': dict(rtol=1e-5, atol=1e-5), 'bf16': dict(rtol=1e-2, atol=1e-2)}
GRAD_TOL = {'f32': dict(rtol=1e-4, atol=1e-4),
            'bf16': dict(rtol=0.1, atol=0.05)}
# (needs_dx, needs_dw) of every backward that launches a kernel
FLAGS = [(True, True), (True, False), (False, True)]
DTYPES = {'f32': (None, None), 'bf16': (jnp.bfloat16, torch.bfloat16)}

# The shapes of the joint model's chains at test width: normal and
# brdf_z (xyz posenc, linear head), lvis (xyz + ldir posenc, sigmoid)
PLANS = {
    'normal': ([(3, 4)], (16,) * 4 + (3,), ('relu',) * 4 + (None,), (2,)),
    'lvis': ([(3, 4), (3, 2)], (32,) * 4 + (1,),
             ('relu',) * 4 + ('sigmoid',), (2,)),
    'brdf_z': ([(3, 4)], (16,) * 2 + (3,), ('relu',) * 2 + (None,), (0,)),
}
RUSINK_PLAN = ([(3, 0), (3, 2)], (16,) * 4 + (1,),
               ('relu',) * 4 + ('softplus',), (2,))


def make_params(plan, seed=0):
    """Glorot-uniform weights and small biases, as (w, b) NumPy pairs."""
    rng = np.random.RandomState(seed)
    out = []
    for din, w in zip(pm.layer_in_dims(plan), plan.widths):
        lim = np.sqrt(6.0 / (din + w))
        out.append((rng.uniform(-lim, lim, (din, w)).astype(np.float32),
                    (0.05 * rng.randn(w)).astype(np.float32)))
    return out


def both(plan_args, seed=0):
    jplan, tplan = pm.make_plan(*plan_args), fm.make_plan(*plan_args)
    p = make_params(jplan, seed)
    return (jplan, [(jnp.asarray(w), jnp.asarray(b)) for w, b in p],
            tplan, [(torch.from_numpy(w), torch.from_numpy(b)) for w, b in p])


def chain_inputs(plan, n=50, seed=1):
    return np.random.RandomState(seed).uniform(
        -1, 1, (n, pm.raw_dim(plan))).astype(np.float32)


@pytest.fixture
def interpret():
    """Runs the JAX Pallas kernels through the interpreter, as the JAX
    package's own kernel tests do."""
    pm.INTERPRET = True
    try:
        yield
    finally:
        pm.INTERPRET = False


def test_plan_helpers_match_jax():
    for args in PLANS.values():
        jplan, tplan = pm.make_plan(*args), fm.make_plan(*args)
        assert tuple(jplan) == tuple(tplan)
        assert fm.embed_dim(tplan) == pm.embed_dim(jplan)
        assert fm.raw_dim(tplan) == pm.raw_dim(jplan)
        assert fm.layer_in_dims(tplan) == pm.layer_in_dims(jplan)
        assert fm.out_dim(tplan) == pm.out_dim(jplan)


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_chain_reference_matches_jax(name, mode):
    jplan, jp, tplan, tp = both(PLANS[name])
    x = chain_inputs(jplan)
    jd, td = DTYPES[mode]
    want = pm.chain_reference(jplan, jnp.asarray(x), jp, compute_dtype=jd)
    got = fm.apply_chain(tplan, torch.from_numpy(x), tp, compute_dtype=td)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[mode])


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_chain_matches_interpreted_pallas_kernel(name, mode, interpret):
    jplan, jp, tplan, tp = both(PLANS[name], seed=2)
    x = chain_inputs(jplan, seed=3)
    jd, td = DTYPES[mode]
    want = pm.apply_chain(jplan, jnp.asarray(x), jp, compute_dtype=jd)
    got = fm.apply_chain(tplan, torch.from_numpy(x), tp, compute_dtype=td)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL[mode])


def test_networks_match_jax_and_chain():
    """networks.apply_mlp (the unfused MLP) against the JAX package's, and
    the chain over posenc inputs against it; glorot bounds and out_dim."""
    import jax
    from nerfactor_tpu.models import networks as jnet
    from nerfactor_tpu_torch.models import networks as tnet
    from nerfactor_tpu_torch.ops import encoding as tenc
    from nerfactor_tpu_torch.utils import ckpt as tckpt
    for skip in ([1], [2]):
        jspec = jnet.MLPSpec(27, [16, 16, 16], acts='relu', skip_at=skip)
        tspec = tnet.MLPSpec(27, [16, 16, 16], acts='relu', skip_at=skip)
        assert tspec.out_dim == jspec.out_dim
        jp = jspec.init(jax.random.PRNGKey(0))
        x = np.random.RandomState(0).randn(9, 27).astype(np.float32)
        np.testing.assert_allclose(
            tspec.apply(tckpt.params_from_jax(jp), torch.from_numpy(x))
            .numpy(), np.asarray(jspec.apply(jp, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5)
    spec = tnet.MLPSpec(27, [16, 16], acts='relu', skip_at=[0])
    head = tnet.MLPSpec(spec.out_dim, [3], acts='sigmoid')
    g = torch.Generator().manual_seed(0)
    p_mlp, p_out = spec.init(g), head.init(g)
    lim = np.sqrt(6.0 / (27 + 16))
    assert p_mlp[0]['w'].abs().max() <= lim and p_mlp[0]['w'].std() > 0
    assert not p_mlp[0]['b'].any()
    x = torch.from_numpy(np.random.RandomState(1).randn(9, 3)
                         .astype(np.float32))
    plan = fm.plan_from_specs([(3, 4)], spec, head)
    np.testing.assert_allclose(
        fm.apply_chain(plan, x, fm.params_from_tree(p_mlp, p_out)).numpy(),
        head.apply(p_out, spec.apply(p_mlp, tenc.posenc(x, 4))).numpy(),
        rtol=1e-5, atol=1e-6)


def test_force_reference_and_params_from_tree():
    jplan, jp, tplan, tp = both(PLANS['normal'])
    x = torch.from_numpy(chain_inputs(jplan))
    tree_mlp = [{'w': w, 'b': b} for w, b in tp[:-1]]
    tree_out = [{'w': tp[-1][0], 'b': tp[-1][1]}]
    p = fm.params_from_tree(tree_mlp, tree_out)
    np.testing.assert_array_equal(
        fm.apply_chain(tplan, x, p, force_reference=True).numpy(),
        fm.chain_reference(tplan, x, tp).numpy())


# ------ K2: the Rusinkiewicz chain ------

def rusink_inputs(n=64, seed=4):
    """Random directions, plus two rows with phi_d 7e-4 from either side
    of its wrap at 0 == pi, and three rows with a == b in the x-z plane
    (phi_d exactly 0 there in every implementation)."""
    rng = np.random.RandomState(seed)
    a = rng.randn(n, 3)
    b = rng.randn(n, 3)
    # a and b in the x-z plane at different polar angles put diff in that
    # plane too (phi_d = 0 or pi); tilting b by +-1e-3 about z moves phi_d
    # just off the wrap, on either side, with a well-conditioned diff
    for k, eps in enumerate((1e-3, -1e-3)):
        ta, tb = 0.3 + 0.1 * k, 0.9 + 0.1 * k
        a[k] = (np.sin(ta), 0.0, np.cos(ta))
        b[k] = (np.sin(tb) * np.cos(eps), np.sin(tb) * np.sin(eps),
                np.cos(tb))
    same = np.asarray([(0.6, 0.0, 0.8), (0.3, 0.0, 0.5), (1.0, 0.0, 0.01)])
    a[-3:], b[-3:] = same, same
    return a.astype(np.float32), b.astype(np.float32)


def rusink_case(seed=4):
    a, b = rusink_inputs(seed=seed)
    z = np.random.RandomState(seed).randn(a.shape[0], 3).astype(np.float32)
    return z, a, b


def assert_rusink_close(got, want, mode, f32_tol=1e-5):
    """The last 3 rows have a == b, where theta_d = acos(~1) moves by up
    to ~3.5e-4 per ulp of its argument (see test_torch_ops): those rows
    get 1e-3 (f32) on top of the mode's tolerance."""
    got, want = np.asarray(got), np.asarray(want)
    tol = dict(TOL[mode])
    if mode == 'f32':
        tol = dict(rtol=f32_tol, atol=f32_tol)
    np.testing.assert_allclose(got[:-3], want[:-3], **tol)
    tol['atol'] = max(tol['atol'], 1e-3)
    np.testing.assert_allclose(got[-3:], want[-3:], **tol)


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_rusink_chain_matches_jax_reference(mode):
    jplan, jp, tplan, tp = both(RUSINK_PLAN, seed=5)
    z, a, b = rusink_case()
    jd, td = DTYPES[mode]
    want = pr.reference(jplan, jnp.asarray(z), jnp.asarray(a),
                        jnp.asarray(b), jp, compute_dtype=jd)
    got = fr.apply_rusink_chain(tplan, torch.from_numpy(z),
                                torch.from_numpy(a), torch.from_numpy(b),
                                tp, compute_dtype=td)
    assert_rusink_close(got.numpy(), want, mode)


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_rusink_chain_matches_interpreted_pallas_kernel(mode, interpret):
    jplan, jp, tplan, tp = both(RUSINK_PLAN, seed=6)
    z, a, b = rusink_case(seed=7)
    jd, td = DTYPES[mode]
    want = pr.apply_rusink_chain(jplan, jnp.asarray(z), jnp.asarray(a),
                                 jnp.asarray(b), jp, compute_dtype=jd)
    got = fr.apply_rusink_chain(tplan, torch.from_numpy(z),
                                torch.from_numpy(a), torch.from_numpy(b),
                                tp, compute_dtype=td)
    # f32 at 1e-4: the TPU kernel builds atan2/acos from a polynomial
    # (~1e-6 rad) and sin/cos from double-angle recurrences, which the
    # posenc frequencies and the weights amplify (the JAX package's own
    # kernel test holds it to 2e-4)
    assert_rusink_close(got.numpy(), want, mode, f32_tol=1e-4)


# ------ gradients ------

def torch_grads(y, inputs, dy):
    return torch.autograd.grad(y, inputs, torch.from_numpy(dy))


@pytest.mark.parametrize('flags', FLAGS)
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_chain_grads_match_interpreted_pallas_kernel(name, mode, flags,
                                                     interpret):
    """K1-bwd's contract: the JAX kernel's (dx, dW, db) for each
    (needs_dx, needs_dw) against autograd of the port's plain version;
    what a flag turns off comes back from the JAX kernel as zeros."""
    import jax
    needs_dx, needs_dw = flags
    jplan, jp, tplan, tp = both(PLANS[name], seed=12)
    x = chain_inputs(jplan, seed=13)
    dy = np.random.RandomState(14).uniform(
        -1, 1, (x.shape[0], jplan.widths[-1])).astype(np.float32)
    jd, td = DTYPES[mode]

    def loss(x_, p_):
        return jnp.sum(pm.apply_chain(jplan, x_, p_, compute_dtype=jd,
                                      needs_dx=needs_dx, needs_dw=needs_dw)
                       * dy)

    gx, gp = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_()
    flat = [t.clone().requires_grad_() for pair in tp for t in pair]
    y = fm.apply_chain(tplan, xt, list(zip(flat[0::2], flat[1::2])),
                       compute_dtype=td, needs_dx=needs_dx, needs_dw=needs_dw)
    got = torch_grads(y, [xt] + flat, dy)
    want = [gx] + [g for pair in gp for g in pair]
    for i, (g, w) in enumerate(zip(got, want)):
        if (needs_dx if i == 0 else needs_dw):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg='cotangent %d' % i,
                                       **GRAD_TOL[mode])
        else:
            assert not np.asarray(w).any()


@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_rusink_grads_match_interpreted_pallas_kernel(mode, interpret):
    """K2-bwd's contract: the JAX kernel's (dz, dldir, dvdir) against
    autograd of the port's plain version (dir2rusink with safe_acos /
    safe_atan2, then the chain). f32 at 2e-3, the JAX package's own bound
    for its kernel (atan polynomial) against its reference; the last 3
    rows (a == b, where d theta_d / d x ~ 1e3) are held to finiteness."""
    import jax
    jplan, jp, tplan, tp = both(RUSINK_PLAN, seed=15)
    z, a, b = rusink_case(seed=16)
    dy = np.random.RandomState(17).uniform(-1, 1, (z.shape[0], 1)).astype(
        np.float32)
    jd, td = DTYPES[mode]

    def loss(*args):
        return jnp.sum(pr.apply_rusink_chain(jplan, *args, jp,
                                             compute_dtype=jd) * dy)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(z), jnp.asarray(a), jnp.asarray(b))
    ins = [torch.from_numpy(v).requires_grad_() for v in (z, a, b)]
    got = torch_grads(fr.apply_rusink_chain(tplan, *ins, tp, compute_dtype=td),
                      ins, dy)
    tol = GRAD_TOL[mode] if mode == 'bf16' else dict(rtol=2e-3, atol=2e-3)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy()[:-3], np.asarray(w)[:-3], **tol)
        assert np.isfinite(g.numpy()).all()


# ------ kernel plumbing that runs without a card ------

def test_desc_and_packing_follow_jax_layout():
    _, _, tplan, tp = both(PLANS['lvis'])
    d = fm.make_desc(tplan)
    dims = fm.layer_in_dims(tplan)
    assert d.n_layers == 5 and d.embed_dim == fm.embed_dim(tplan) == 42
    assert d.raw_dim == 6 and d.max_width == 32
    assert [d.part_dim[i] for i in range(2)] == [3, 3]
    assert [d.part_freqs[i] for i in range(2)] == [4, 2]
    assert [d.skip_after[i] for i in range(5)] == [0, 0, 1, 0, 0]
    assert [d.acts[i] for i in range(5)] == [1, 1, 1, 1, 2]
    w_flat, b_flat = fm.pack_params(tplan, tp, torch.float32)
    for i, (w, b) in enumerate(tp):
        w_off, b_off = d.w_off[i], d.b_off[i]
        np.testing.assert_array_equal(
            w_flat[w_off:w_off + dims[i] * tplan.widths[i]].reshape(
                dims[i], tplan.widths[i]).numpy(), w.numpy())
        np.testing.assert_array_equal(
            b_flat[b_off:b_off + tplan.widths[i]].numpy(), b.numpy())
    w_bf, _ = fm.pack_params(tplan, tp, torch.bfloat16)
    assert w_bf.dtype == torch.bfloat16


def test_kernel_refuses_what_it_does_not_take():
    """A plan with a skip after its last layer runs (as K1w, on either
    route; here its plain version), each wrapper refuses the other kind of
    plan, and the kernels refuse CPU tensors and unknown types."""
    last_skip = fm.make_plan([(3, 2)], (8, 8), ('relu', 'relu'), (1,))
    assert fm.kernel_supports(last_skip)
    d = fm.make_desc(last_skip)
    assert [d.skip_after[i] for i in range(2)] == [0, 1]
    p8 = [(torch.ones(d_in, w), torch.zeros(w)) for d_in, w in
          zip(fm.layer_in_dims(last_skip), last_skip.widths)]
    x8 = torch.from_numpy(chain_inputs(last_skip, n=7))
    for transposed in (True, False):
        y = fm._fused_chain(last_skip, x8, p8, transposed=transposed)
        assert y.shape == (7, 8 + fm.embed_dim(last_skip))
        np.testing.assert_array_equal(y.numpy(), fm.chain_reference(
            last_skip, x8, p8).numpy())
    with pytest.raises(ValueError, match='K1-fwd'):
        fm.chain_kernel(last_skip, x8, p8)
    with pytest.raises(ValueError, match='K1r-fwd'):
        fm.chain_kernel_stash(last_skip, x8, p8)
    _, _, tplan, tp = both(PLANS['normal'])
    x = torch.from_numpy(chain_inputs(tplan))
    with pytest.raises(ValueError, match='K1w-fwd'):
        fm.chain_kernel_last_skip(tplan, x, tp)
    with pytest.raises(ValueError, match='CUDA'):  # a CPU tensor
        fm.chain_kernel(tplan, x, tp)
    with pytest.raises(ValueError):
        fm.kernel_dtype(torch.float16)
    with pytest.raises(ValueError, match='nothing to compute'):
        fm.chain_kernel_bwd(tplan, x, x[:, :3], tp, needs_dx=False,
                            needs_dw=False)
    with pytest.raises(ValueError, match='CUDA'):
        fm.chain_kernel_bwd(tplan, x, x[:, :3], tp)


def test_build_key_tracks_the_sources():
    key = kernel_lib.build_key()
    assert len(key) == 16 and key == kernel_lib.build_key()
    names = [p.rsplit('/', 1)[-1] for p in kernel_lib._sources()]
    assert names == ['chain_f32_tc.cu', 'chain_mlp.cuh', 'chain_tc.cuh',
                     'dot_probe.cu', 'dot_probe_mma.cu', 'fused_mlp.cu',
                     'fused_nerf.cu', 'fused_rusink.cu', 'mma_bf16.cuh',
                     'pack_transposed.cu', 'wgmma.cuh']


# ------ on the card ------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n', [1, 50, 4099])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_chain_kernel_matches_plain_on_card(name, mode, n, cuda):
    _, _, tplan, tp = both(PLANS[name], seed=8)
    x = torch.from_numpy(chain_inputs(tplan, n=n, seed=9)).to(cuda)
    tp = [(w.to(cuda), b.to(cuda)) for w, b in tp]
    td = DTYPES[mode][1]
    launches = fm.chain_kernel.launches
    with torch.no_grad():
        got = fm.apply_chain(tplan, x, tp, compute_dtype=td)
        want = fm.chain_reference(tplan, x, tp, compute_dtype=td)
    torch.cuda.synchronize()
    assert fm.chain_kernel.launches == launches + 1
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               **TOL[mode])


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_rusink_kernel_matches_plain_on_card(mode, cuda):
    _, _, tplan, tp = both(RUSINK_PLAN, seed=10)
    z, a, b = (torch.from_numpy(v).to(cuda) for v in rusink_case(seed=11))
    tp = [(w.to(cuda), b_.to(cuda)) for w, b_ in tp]
    td = DTYPES[mode][1]
    launches = fr.rusink_kernel.launches
    with torch.no_grad():
        got = fr.apply_rusink_chain(tplan, z, a, b, tp, compute_dtype=td)
        want = fr.reference(tplan, z, a, b, tp, compute_dtype=td)
    torch.cuda.synchronize()
    assert fr.rusink_kernel.launches == launches + 1
    assert_rusink_close(got.cpu().numpy(), want.cpu().numpy(), mode)


def rel_norm(got, want):
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


# Per-leaf relative norm of dW/db (sums over all rows): f32 differs only
# in summation order; bf16 rounds at other places in the two versions
# (see GRAD_TOL). bf16 dx is held to the same norm bound: dx sums
# 2^j (cos g_sin - sin g_cos) over the octaves, and where that cancels the
# two roundings part in single elements (4 of 12,297 beyond GRAD_TOL at
# 4,099 rows). Readings on an H100 over these plans, 1 to 4,099 rows and
# 6 seeds: bf16 kernel vs plain up to 0.072 (lvis, 50 rows), and the f32
# kernel vs plain bf16 down to 0.052 there. At these widths and sizes the
# bound cannot tell the bf16 gradient from the f32 one; the rounding
# policy is held by test_torch_emu (against the TPU kernel's, at 0.01)
# and by chip_smoke.py (against the plain version at 1M rows, at 0.025).
DW_TOL = {'f32': 1e-4, 'bf16': 0.1}


@pytest.mark.cuda
@pytest.mark.parametrize('flags', FLAGS + [(False, False)])
@pytest.mark.parametrize('n', [1, 50, 4099])
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
@pytest.mark.parametrize('name', sorted(PLANS))
def test_chain_kernel_bwd_matches_plain_on_card(name, mode, n, flags, cuda):
    """apply_chain under autograd launches K1-fwd and K1-bwd (none with
    both flags off, zeros then) and matches autograd of the plain version."""
    needs_dx, needs_dw = flags
    _, _, tplan, tp = both(PLANS[name], seed=18)
    x = torch.from_numpy(chain_inputs(tplan, n=n, seed=19)).to(cuda)
    dy = np.random.RandomState(20).uniform(
        -1, 1, (n, tplan.widths[-1])).astype(np.float32)
    td = DTYPES[mode][1]
    flat = [t.to(cuda) for pair in tp for t in pair]

    def grads(fn, **kw):
        ins = [x.clone().requires_grad_()] + [
            t.clone().requires_grad_() for t in flat]
        y = fn(tplan, ins[0], list(zip(ins[1::2], ins[2::2])),
               compute_dtype=td, **kw)
        return torch.autograd.grad(y, ins, torch.from_numpy(dy).to(cuda))

    launches = fm.chain_kernel_bwd.launches
    got = grads(fm.apply_chain, needs_dx=needs_dx, needs_dw=needs_dw)
    want = grads(fm.chain_reference)
    torch.cuda.synchronize()
    assert fm.chain_kernel_bwd.launches == launches + int(needs_dx or needs_dw)
    if needs_dx and mode == 'f32':
        np.testing.assert_allclose(got[0].cpu().numpy(),
                                   want[0].cpu().numpy(), **GRAD_TOL[mode])
    elif needs_dx:
        assert rel_norm(got[0], want[0]) <= DW_TOL[mode]
    else:
        assert not got[0].any()
    for g, w in zip(got[1:], want[1:]):
        if needs_dw:
            assert rel_norm(g, w) <= DW_TOL[mode]
        else:
            assert not g.any()


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_chain_kernel_bwd_is_deterministic(mode, cuda):
    _, _, tplan, tp = both(PLANS['lvis'], seed=21)
    x = torch.from_numpy(chain_inputs(tplan, n=70001, seed=22)).to(cuda)
    dy = torch.rand(x.shape[0], 1, device=cuda)
    tp = [(w.to(cuda), b.to(cuda)) for w, b in tp]
    td = DTYPES[mode][1]
    runs = [fm.chain_kernel_bwd(tplan, x, dy, tp, td, needs_dx=False)[1]
            for _ in range(2)]
    for (w1, b1), (w2, b2) in zip(*runs):
        assert torch.equal(w1, w2) and torch.equal(b1, b2)


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['f32', 'bf16'])
def test_rusink_kernel_bwd_matches_plain_on_card(mode, cuda):
    """apply_rusink_chain under autograd launches K2-fwd and K2-bwd: input
    cotangents as autograd of the plain version (the last 3 rows, a == b,
    held to finiteness: see test_rusink_grads_match_interpreted_pallas_kernel),
    zero weight cotangents."""
    _, _, tplan, tp = both(RUSINK_PLAN, seed=23)
    ins = [torch.from_numpy(v).to(cuda) for v in rusink_case(seed=24)]
    dy = torch.from_numpy(np.random.RandomState(25).uniform(
        -1, 1, (ins[0].shape[0], 1)).astype(np.float32)).to(cuda)
    flat = [t.to(cuda) for pair in tp for t in pair]
    td = DTYPES[mode][1]

    def grads(fn):
        args = [t.clone().requires_grad_() for t in ins + flat]
        y = fn(tplan, *args[:3], list(zip(args[3::2], args[4::2])),
               compute_dtype=td)
        return torch.autograd.grad(y, args, dy)

    launches = fr.rusink_kernel_bwd.launches
    got = grads(fr.apply_rusink_chain)
    want = grads(fr.reference)
    torch.cuda.synchronize()
    assert fr.rusink_kernel_bwd.launches == launches + 1
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_allclose(g.cpu().numpy()[:-3], w.cpu().numpy()[:-3],
                                   **GRAD_TOL[mode])
        assert torch.isfinite(g).all()
    assert not any(g.any() for g in got[3:])
