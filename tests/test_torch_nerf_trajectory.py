"""A multi-step NeRF trajectory of the PyTorch port against the JAX
package's (CPU): both start from one JAX-written ckpt-1 (params and the
optimizer state after one JAX step), the port through
``utils/ckpt.CheckpointManager.restore`` (``params_from_jax``), and take
five train steps of their own ``make_train_step`` on the same rays, the
JAX package's random draws (stratified depths, sigma noise, importance
samples) replayed into the port's explicit-draw arguments, as
tests/test_torch_nerf.py does for one step.

At a small width (trunk 32 x 4, 8 + 16 samples, 64 rays, 4 xyz octaves:
tests/test_torch_nerf.py's MODEL_BASE) with nerf.ini's perturbation and
sigma noise on and lr 5e-3, after every step:

  * the loss within LOSS_RTOL relative;
  * every leaf within LEAF_TOL by relative norm of the difference.

Readings (the limits set from them): f32 loss <= 1.8e-7 and leaves <=
3.9e-6 over the five steps (growing from 5.9e-7); bf16 loss <= 1.6e-4
and leaves <= 0.014 (growing from 3.2e-4: each package rounds at its
own places and Adam's normalized steps carry the sign of small
gradients). The bf16 limit's control: the JAX package's own bf16
trajectory against its f32 one on the same draws reads 0.23-0.32.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerfactor_tpu.models.nerf import Model as JModel
from nerfactor_tpu.parallel import train as jtrain
from nerfactor_tpu.utils import ckpt as jckpt
from nerfactor_tpu_torch.models.nerf import Model as TModel
from nerfactor_tpu_torch.parallel import train as ttrain
from nerfactor_tpu_torch.utils import ckpt as tckpt
from tests.test_torch_nerf import jax_draws, nerf_config, ray_batch, rel_norm

N_STEPS, N_RAYS = 5, 64
CASES = {'f32': 'bf16_big_chains=False', 'bf16': ''}
LOSS_RTOL = {'f32': 1e-5, 'bf16': 5e-3}
LEAF_TOL = {'f32': 1e-5, 'bf16': 0.05}


class Replay:
    """The port's NeRF model with the JAX draws of the current step
    (``draws``) fed to every train-mode ``apply``."""

    def __init__(self, model):
        self.model = model
        self.draws = None

    def apply(self, params, arrays, mode='train', generator=None,
              jitter_noise=None):
        return self.model.apply(params, arrays, mode=mode, **self.draws)

    def compute_loss(self, *args, **kwargs):
        return self.model.compute_loss(*args, **kwargs)


@pytest.mark.parametrize('case', sorted(CASES))
def test_nerf_trajectory_matches_jax(case, tmp_path):
    config = nerf_config(CASES[case], lr='5e-3', noise_std='0.5')
    jmodel = JModel(config)
    jparams = jmodel.init_params(jax.random.PRNGKey(15))
    jopt = jtrain.build_optimizer(config)
    jstep = jtrain.make_train_step(jmodel, jopt)
    batches = [ray_batch(N_RAYS, seed=40 + i) for i in range(N_STEPS + 1)]
    keys = [jax.random.PRNGKey(50 + i) for i in range(N_STEPS + 1)]

    def jbatch(i):
        return {k: jnp.asarray(v) for k, v in batches[i].items()}
    jparams, jopt_state, _ = jstep(jparams, jopt.init(jparams), jbatch(0),
                                   keys[0])
    ckptdir = str(tmp_path / 'checkpoints')
    jckpt.save_pytree({'params': jparams, 'opt_state': jopt_state},
                      ckptdir + '/ckpt-1')

    tmodel = TModel(config, device='cpu')
    topt = ttrain.build_optimizer(config)
    template = tmodel.init_params(torch.Generator().manual_seed(0))
    state = tckpt.CheckpointManager(ckptdir).restore(
        {'params': template, 'opt_state': topt.init(template)})
    params, opt_state = state['params'], state['opt_state']
    assert int(opt_state[0].count) == 1
    replay = Replay(tmodel)
    tstep = ttrain.make_train_step(replay, topt)
    for i in range(1, N_STEPS + 1):
        jparams, jopt_state, jloss = jstep(jparams, jopt_state, jbatch(i),
                                           keys[i])
        replay.draws = jax_draws(tmodel, keys[i], N_RAYS)
        params, opt_state, loss = tstep(
            params, opt_state,
            {k: torch.from_numpy(v) for k, v in batches[i].items()})
        np.testing.assert_allclose(loss.item(), float(jloss),
                                   rtol=LOSS_RTOL[case],
                                   err_msg='step %d' % i)
        want = jax.tree_util.tree_leaves(jparams)
        got = tckpt.tree_leaves(params)
        assert len(got) == len(want)
        errs = [rel_norm(g.numpy(), np.asarray(w))
                for g, w in zip(got, want)]
        assert max(errs) <= LEAF_TOL[case], (i, errs)
    assert int(opt_state[0].count) == int(jopt_state[-1].count) \
        == N_STEPS + 1
