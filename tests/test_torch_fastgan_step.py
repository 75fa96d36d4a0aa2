'''One FastGAN training step of the port against JAX's
`FastGAN/utils.py:build_train_step`, with `ema` off and on, and the
assembled recipe on the CPU.

Both sides start from one bridged state (the 32px G and BatchNorm D of
`tests/test_torch_fastgan.py`, with every BatchNorm's statistics and affine
moved off their init values; batch 8, f32 on the CPU) and get the same
draws: z, DiffAugment's for ar, af and ag with policy
'color,translation,cutout' (replayed by `test_torch_diffaugment.jax_draws`)
and the part quadrants of pk1 and pk2 (`FastGAN/utils.py:28`). The step
runs plain SGD on both sides and each keeps the raw gradients (JAX in the
optimizer state, the port in `.grad`). Everything the step leaves (losses,
reconstructions, gradients, parameters, each spectral norm's u, the
BatchNorm running statistics, G_ema) is compared at 1e-4 of its scale, as
`tests/test_torch_step.py` does (f32 through G, DiffAugment and D, forward
and backward, in two frameworks).
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.FastGAN import model as jm
from animeface_tpu.implementations.FastGAN import utils as ju
from animeface_tpu.nnutils.loss import HingeLoss as JHinge
from animeface_tpu_torch.convert import (
    convert_fastgan_discriminator, convert_fastgan_generator)
from animeface_tpu_torch.implementations.FastGAN import utils as tu
from animeface_tpu_torch.nnutils.loss import HingeLoss
from test_torch_diffaugment import jax_draws
from test_torch_fastgan import B, DCFGS, GCFG, Z, _check_state, _nhwc, _perturb_stats
from test_torch_step import _sgd_keeping_grads, _close, _nchw, LR

RTOL = 1e-4
POLICY = 'color,translation,cutout'

ARGS = tu.default_args(image_size=32, batch_size=B, latent_dim=Z, g_channels=4,
                       g_max_channels=16, d_channels=4, d_max_channels=16,
                       init_down_size=32, decoder_image_size=16, no_bf16=True, policy=POLICY)


@pytest.fixture(scope='module')
def setup():
    jG, jD = jm.Generator(**GCFG), jm.Discriminator(**DCFGS['bn32'])
    gv = jax.jit(lambda k: jG.init({'params': k}, jnp.zeros((2, Z)), train=True))(
        jax.random.PRNGKey(0))
    dv = jax.jit(lambda k: jD.init({'params': k, 'part': k}, jnp.zeros((2, 32, 32, 3)),
                                   train=True))(jax.random.PRNGKey(2))
    return jG, jD, _perturb_stats(gv, 1), _perturb_stats(dv, 3)


@pytest.mark.parametrize('use_ema', [False, True], ids=['no-ema', 'ema'])
def test_step_matches_jax(setup, use_ema):
    jG, jD, gv, dv = setup
    sgd = _sgd_keeping_grads()
    real = np.clip(np.random.default_rng(6).standard_normal((B, 32, 32, 3)), -1,
                   1).astype(np.float32)
    state = dict(rng=jax.random.PRNGKey(11), G=gv, D=dv, G_ema=copy.deepcopy(gv),
                 g_opt=sgd.init(gv['params']), d_opt=sgd.init(dv['params']),
                 step=jnp.int32(0))
    step = ju.build_train_step(jG, jD, sgd, sgd, JHinge(), POLICY, use_ema)
    jnew, jmetrics, jrecons = jax.device_get(jax.jit(step)(state, jnp.asarray(real)))
    _, zkey, ar, af, ag, pk1, pk2, _ = jax.random.split(state['rng'], 8)
    qid = [int(jax.random.randint(k, (), 0, 4)) for k in (pk1, pk2)]
    draws = dict(z=torch.from_numpy(np.array(jax.random.normal(zkey, (B, Z)))),
                 aug_r=jax_draws(ar, real.shape, POLICY), aug_f=jax_draws(af, real.shape, POLICY),
                 aug_g=jax_draws(ag, real.shape, POLICY), qid=torch.tensor(qid))

    G, D, G_ema = tu.build_models(ARGS, device='cpu')
    G.load_state_dict(convert_fastgan_generator(gv))
    G_ema.load_state_dict(convert_fastgan_generator(gv))
    D.load_state_dict(convert_fastgan_discriminator(dv))
    tstate = dict(step=0, generator=None)
    tstep = tu.build_train_step(G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
                                torch.optim.SGD(D.parameters(), lr=LR), HingeLoss(), POLICY,
                                use_ema)
    metrics, recons = tstep(tstate, _nchw(real), draws)

    assert sorted(metrics) == sorted(jmetrics) == ['D', 'G']
    _close(metrics['G'], jmetrics['G'], rtol=RTOL, what='G loss')
    _close(metrics['D'], jmetrics['D'], rtol=RTOL, what='D loss')
    for g, w in zip(recons, jrecons):
        _close(_nhwc(g), w, rtol=RTOL, what='recons')
    for port, new, grads, convert in ((G, jnew['G'], jnew['g_opt'], convert_fastgan_generator),
                                      (D, jnew['D'], jnew['d_opt'], convert_fastgan_discriminator)):
        want_grad = convert(dict(new, params=grads))
        for name, p in port.named_parameters():
            _close(p.grad, want_grad[name], rtol=RTOL, what=f'grad {name}')
        _check_state(port, new, convert, rtol=RTOL, what='new state')
    _check_state(G_ema, jnew['G_ema'], convert_fastgan_generator, rtol=RTOL, what='G_ema')
    if not use_ema:
        _check_state(G_ema, gv, convert_fastgan_generator, rtol=0, what='G_ema unchanged')
    assert tstate['step'] == 1


def test_recipe_training_and_sampler_on_cpu():
    '''`build_training` on the CPU: two steps with the default draws give
    finite losses and reconstructions, the part quadrants lie in [0, 4),
    and `sample_fn` runs G in eval mode.'''
    run = tu.build_training(tu.default_args(**dict(vars(ARGS), num_test=4)), device='cpu')
    real = torch.rand((B, 3, 32, 32), generator=torch.Generator().manual_seed(1)) * 2 - 1
    draws = tu.draw_step_inputs(run.G, real, run.state['generator'], ARGS.policy)
    assert draws['qid'].shape == (2,) and 0 <= int(draws['qid'].min()) <= int(
        draws['qid'].max()) < 4
    for _ in range(2):
        metrics, recons = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        assert len(recons) == 4 and all(bool(torch.isfinite(r).all()) for r in recons)
    assert run.state['step'] == 2
    images = run.sample_fn()
    assert images.shape == (4, 3, 32, 32) and bool(torch.isfinite(images).all())
