'''The StyleGAN3 training step with its DEFAULT augmentation, DiffAugment with
the recipe's policy (here 'color,translation,cutout'), against the JAX step,
which defaults to it too (`StyleGAN3/utils.py:36-38`), plain and R1.

Both sides start from one bridged state (the small model, batch 8 and f32
on the CPU of `tests/test_torch_ada_step.py`, whose helpers this file uses)
and get the same draws: z from the step's key split and DiffAugment's draws
replayed from its augment keys by `test_torch_diffaugment.jax_draws`: the
reals take ar's, the fakes af's in both phases ("same key: same aug",
`StyleGAN3/utils.py:52-53,76`). The steps run plain SGD on both sides and
keep the raw gradients, compared at 1e-4 of each tensor's scale.
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.StyleGAN3 import utils as ju3
from animeface_tpu.nnutils.loss import NonSaturatingLoss as JLoss
from animeface_tpu.utils import EasyDict
from animeface_tpu_torch.convert import (
    convert_stylegan3_discriminator, convert_stylegan3_generator)
from animeface_tpu_torch.implementations.StyleGAN3 import utils as tu3
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
import test_torch_ada_step as sg3t
from test_torch_diffaugment import jax_draws
from test_torch_diffaugment_steps import POLICY, RTOL, _check_module

LR = sg3t.LR


@pytest.fixture(scope='module')
def sg3():
    args = EasyDict(vars(sg3t.ARGS))
    jG, jD = ju3.build_models(args, jnp.float32)
    gv = jax.device_get(jax.jit(jG.init)({'params': jax.random.PRNGKey(0)},
                                         jnp.zeros((1, sg3t.L))))
    dp = jax.device_get(jax.jit(jD.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((2, sg3t.N, sg3t.N, 3)))['params'])
    real = np.clip(np.random.default_rng(0).standard_normal((sg3t.B, sg3t.N, sg3t.N, 3)),
                   -1, 1).astype(np.float32)
    return jG, jD, gv['params'], gv['moments'], dp, real


@pytest.mark.parametrize('do_r1', [False, True], ids=['plain', 'r1'])
def test_stylegan3_default_diffaugment_step_matches_jax(sg3, do_r1):
    jG, jD, gp, gm, dp, real = sg3
    sgd = sg3t._sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(42), G=gp, D=dp, G_moments=gm,
                 G_ema=copy.deepcopy(gp), g_opt=sgd.init(gp), d_opt=sgd.init(dp),
                 step=jnp.int32(0))
    step = ju3.build_train_step(jG, jD, sgd, sgd, JLoss(), POLICY, sg3t.ARGS.gp_lambda, do_r1)
    jnew, jmetrics = jax.device_get(jax.jit(step)(state, jnp.asarray(real)))
    _, zkey, ar, af, _ = jax.random.split(state['rng'], 5)
    draws = dict(z=torch.from_numpy(np.array(jax.random.normal(zkey, (sg3t.B, sg3t.L)))),
                 aug_r=jax_draws(ar, real.shape, POLICY),
                 aug_f=jax_draws(af, real.shape, POLICY))

    G, D, G_ema = sg3t._port(sg3[:2] + (gp, gm, dp, real, None, None))
    tstate = dict(step=0, generator=None)
    tstep = tu3.build_train_step(
        G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
        torch.optim.SGD(D.parameters(), lr=LR), NonSaturatingLoss(), sg3t.ARGS.gp_lambda, do_r1,
        policy=POLICY)
    metrics = tstep(tstate, sg3t._nchw(real), draws)

    assert sorted(metrics) == sorted(jmetrics)
    sg3t._close(metrics['g'], jmetrics['g'], what='G loss')
    sg3t._close(metrics['d'], jmetrics['d'], what='D loss')
    new_moments = jnew['G_moments']
    _check_module(G, jnew['g_opt'], jnew['G'],
                  lambda t: convert_stylegan3_generator(t, new_moments), RTOL)
    _check_module(D, jnew['d_opt'], jnew['D'], convert_stylegan3_discriminator, RTOL)
    want = convert_stylegan3_generator(jnew['G_ema'], new_moments)
    for name, v in G_ema.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=name)
    for name, v in G.state_dict().items():                 # the D-phase moments
        if 'magnitude_ema' in name or 'w_avg' in name:
            sg3t._close(v.numpy(), want[name].numpy(), rtol=1e-5, what=name)
    assert tstate['step'] == 1


def test_stylegan3_recipe_defaults_to_diffaugment():
    '''`build_training` of the plain recipe on the CPU at a tiny size: the
    policy is the recipe's, R1 at step % gp_every == 0, and the default
    draws give the reals and the fakes their own.'''
    args = tu3.default_args(**{k: v for k, v in vars(sg3t.ARGS).items()
                               if k in tu3.STYLEGAN3_DEFAULTS})
    assert args.policy == 'color,translation'
    run = tu3.build_training(args, device='cpu', seed=0)
    assert [run.uses_r1(i) for i in (0, 1, 15, 16)] == [True, False, False, True]
    real = torch.rand((sg3t.B, 3, sg3t.N, sg3t.N),
                      generator=torch.Generator().manual_seed(1)) * 2 - 1
    draws = tu3.draw_step_inputs(run.G, real, run.state['generator'], args.policy)
    assert len(draws['aug_r']) == len(draws['aug_f']) == 4
    assert not torch.equal(draws['aug_r'][0], draws['aug_f'][0])
    for _ in range(2):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 2
