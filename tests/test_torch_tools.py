"""The port's step and relight tools (nerfactor_tpu_torch/tools/
step_time.py, profile_joint.py, bench_relight.py) on the CPU at small
sizes, where they check themselves and measure nothing of the card: each
prints one JSON line; bench_relight's two epilogues (the model's
materialization-free ``render`` and the (N, L, 3) contribution tensor)
agree within REL_TOL, and both match the JAX model's ``render`` on the
same inputs and weights (the JAX harness's model, its parameters carried
over by ``utils/ckpt.params_from_jax``) within REL_TOL by relative norm.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import torch

from __graft_entry__ import _make_model_and_batch
from nerfactor_tpu_torch.tools import (
    bench_model, bench_relight, profile_joint, step_time)
from nerfactor_tpu_torch.utils import ckpt as tckpt

REL_TOL = bench_relight.REL_TOL
SMALL = ['--device', 'cpu', '--rays', '32', '--light_h', '2']
TINY_JOINT = ['--override', bench_model.TINY]
TINY_NERF = ['--override', 'mlp_width=32,enc_depth=2,n_samples_coarse=8,'
             'n_samples_fine=8']


def printed(capsys):
    """The one JSON line the tool printed last."""
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_step_time_prints_its_record(capsys):
    for model, tiny in (('nerfactor', TINY_JOINT), ('nerf', TINY_NERF)):
        got = step_time.main(['--model', model, '--steps', '2',
                              '--warmup', '1'] + SMALL + tiny)
        assert printed(capsys) == got
        assert got['clock'] == 'host' and got['card'] is None
        assert got['ms_per_step'] > 0 and np.isfinite(got['loss'])
        assert got['launches_per_step'] == {}  # the plain versions


def test_profile_joint_prints_its_record(capsys):
    got = profile_joint.main(['--steps', '1', '--warmup', '1', '--top', '4']
                             + SMALL + TINY_JOINT)
    assert printed(capsys) == got
    assert len(got['top_host_ms']) == 4
    assert all(ms >= 0 for _, ms in got['top_host_ms'])
    assert 'launches' not in got  # the card's kernels only


def test_bench_relight_epilogues_agree(capsys):
    got = bench_relight.main(['--device', 'cpu', '--rows', '64',
                              '--light_h', '2', '--probes', '2',
                              '--steps', '1', '--warmup', '1'])
    assert printed(capsys) == got
    assert got['rel_err'] <= REL_TOL
    assert got['config'] == {'rows': 64, 'lights': 8, 'olat': True,
                             'n_olat': 8, 'probes': 2}
    np.testing.assert_allclose(got['factored']['checksum'],
                               got['materialized']['checksum'], rtol=1e-5)


def rel_norm(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


def test_bench_relight_epilogues_match_jax_render():
    jmodel, _ = _make_model_and_batch(n_rays=8, light_h=4, tiny=True)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    model, params, _ = bench_model.make('nerfactor', 'cpu', n_rays=8,
                                        light_h=4, override=bench_model.TINY)
    carried = tckpt.params_from_jax(jax.device_get(jparams))
    assert sorted(carried) == sorted(params)
    x = bench_relight.relight_inputs(model, 48, 3, 'cpu', seed=1)
    jmodel.probes_flat = jnp.asarray(model.probes_flat.numpy())
    want = jmodel.render(jparams, *(jnp.asarray(x[k]) for k in (
        'lvis', 'spec', 'albedo', 'l', 'n')), relight_olat=True,
        relight_probes=True)
    xt = {k: torch.from_numpy(v) for k, v in x.items()}
    for epilogue in (bench_relight.factored, bench_relight.materialized):
        got = epilogue(model, carried, xt, True)
        assert [tuple(g.shape) for g in got] == [w.shape for w in want]
        for g, w in zip(got, want):
            assert rel_norm(g.numpy(), w) <= REL_TOL, epilogue.__name__
