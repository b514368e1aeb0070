"""The joint NeRFactor model's training step (``models/nerfactor.py``
under ``parallel/train.py``): the forward and backward products of its
chains a step, the recomputed forwards of the kernels' backwards not
counted. The four heads and the visibility chain run on the rays and
their jitter twins (every smoothness weight is above 0); the frozen BRDF
prior on rays x lights, with no weight gradients but its input's
cotangent (the latent code and the normals train through it)."""

from perfbench.counts import chain


def chains(cfg):
    """{name: (layers, rows, trains its weights, input's cotangent)}."""
    v, b = cfg['values'], cfg['brdf_prior']
    n, n_l = v['n_rays_per_step'], 2 * v['light_h'] ** 2
    xyz = 3 * (1 + 2 * v['n_freqs_xyz'])
    ldir = 3 * (1 + 2 * v['n_freqs_ldir'])
    hid = [v['mlp_width']] * v['mlp_depth']
    skip = {v['mlp_skip_at']}

    def head(in_dim, out):
        return chain.layers(in_dim, hid + [out], skip)
    brdf_in = b['z_dim'] + 3 * (1 + 2 * b['n_freqs'])
    return {
        'normal': (head(xyz, 3), 2 * n, True, False),
        'albedo': (head(xyz, 3), 2 * n, True, False),
        'brdf_z': (head(xyz, b['z_dim']), 2 * n, True, False),
        'lvis': (head(xyz + ldir, 1), 2 * n * n_l, True, False),
        'brdf': (chain.layers(brdf_in, [b['mlp_width']] * b['mlp_depth']
                              + [1], {b['mlp_skip_at']}), n * n_l, False,
                 True)}


def train_step_flops(cfg):
    total = 0
    for ls, rows, trains, to_input in chains(cfg).values():
        total += chain.fwd(ls, rows) + chain.dx(ls, rows, to_input)
        if trains:
            total += chain.dw(ls, rows)
    return total
