"""The kernels' and model steps' operation and byte counts against hand
counts at the published widths."""

from perfbench import harness

P = 989e12


def counts(name):
    return harness.load_module('counts', name)


def test_k1_bwd_on_the_visibility_chain():
    cfg = harness.load_json('configs', 'nerfactor_joint')
    ls, rows, trains, to_input = counts('nerfactor_joint').chains(cfg)['lvis']
    # posenc(xyz, 10) + posenc(ldir, 4) = 63 + 27 in; 128 x 4, the input
    # joined after layer 2; a 1-wide head; the rays and their jitter twins
    assert [(a, b) for a, b, _ in ls] == [(90, 128), (128, 128), (128, 128),
                                           (218, 128), (128, 1)]
    assert rows == 2 * 1024 * 512 and trains and not to_input
    macs = 90 * 128 + 128 * 128 + 128 * 128 + 218 * 128 + 128
    hidden = 3 * 128 * 128 + 128
    ops, byt = counts('K1-bwd').cost(ls, rows, raw_in=6, out=1)
    assert ops == 2 * rows * (2 * macs + hidden)
    weights = macs + 4 * 128 + 1
    assert byt == 4 * rows * 7 + 2 * weights + 4 * weights
    # The kernel table's bound (PERF.md): 0.411 ms, by operations
    assert abs(ops / P * 1e3 - 0.411) < 0.001


def test_k3_bwd_and_the_nerf_step():
    cfg = harness.load_json('configs', 'nerf')
    v = cfg['values']
    ls = counts('K3-bwd').field_layers(v)
    macs = (63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256
            + 256 + 256 * 256 + 283 * 128 + 128 * 3)
    assert sum(a * b for a, b, _ in ls) == macs == 593408
    hidden = 7 * 256 * 256 + 256 + 256 * 256 + 256 * 128 + 128 * 3
    rows = counts('nerf').train_rows(v)
    assert rows == (1024 * 64, 1024 * 192)
    ops, _ = counts('K3-bwd').cost(v, rows[1])
    assert ops == 2 * rows[1] * (2 * macs + hidden)
    assert abs(ops / P * 1e3 - 0.694) < 0.001
    assert counts('nerf').train_step_flops(cfg) == \
        2 * sum(rows) * (2 * macs + hidden)


def test_the_march_and_k1_fwd():
    cfg = harness.load_json('configs', 'nerf')
    v = cfg['values']
    nerf = counts('nerf')
    assert nerf.march_rows(v) == (128, 320)
    macs = 63 * 256 + 4 * 256 * 256 + 319 * 256 + 2 * 256 * 256 + 256
    assert nerf.march_flops_per_ray(cfg) == 2 * 448 * macs
    ops, byt = counts('K1-fwd').cost(nerf.sigma_layers(v), 26112 * 320,
                                     raw_in=3, out=1)
    assert ops == 2 * 26112 * 320 * macs
    # PERF.md's bound for a march block's fine pass: 8.30 ms
    assert abs(ops / P * 1e3 - 8.30) < 0.01
    assert byt / 3.35e12 < ops / P


def test_the_joint_step():
    cfg = harness.load_json('configs', 'nerfactor_joint')
    n, nl = 2048, 2 * 1024 * 512
    head = 63 * 128 + 2 * 128 * 128 + 191 * 128
    hid = 3 * 128 * 128
    lvis = 90 * 128 + 2 * 128 * 128 + 218 * 128 + 128
    brdf = 18 * 128 + 2 * 128 * 128 + 146 * 128 + 128
    want = 0
    for out in (3, 3, 3):
        want += 2 * n * (2 * (head + 128 * out) + hid + 128 * out)
    want += 2 * nl * (2 * lvis + hid + 128)
    want += 2 * (nl // 2) * (2 * brdf)
    assert counts('nerfactor_joint').train_step_flops(cfg) == want
