'''One BigGAN training step of the port against JAX's
`BigGAN/utils.py:build_train_step`, with `ema` off and on, and the
assembled recipe on the CPU. SEBigGAN's ICR step is in
`tests/test_torch_sebiggan_step.py`.

Both sides start from one bridged state (32px, channels 4, z 16, 'sa'
attention, batch 4, f32 on the CPU; variables from
`test_torch_biggan.init_vars`, with gamma, every running statistic and
every u off its init value) and get the same draws: z and DiffAugment's
for ar, af and ag (`BigGAN/utils.py:23`, policy 'color,translation',
replayed by `test_torch_diffaugment.jax_draws`). The step runs plain SGD
on both sides and each keeps the raw gradients (JAX in the optimizer
state, the port in `.grad`). Everything the step leaves (losses,
gradients, parameters, each spectral norm's u, the running statistics,
G_ema) is compared at 1e-4 of its scale, as
`tests/test_torch_fastgan_step.py` does; a gradient's scale is floored at
1e-3 of its model's largest (a conv bias before a train-mode BatchNorm has
a structurally zero gradient, f32 rounding on both sides). JAX runs its
step once, with the EMA on (one compile); the port's step without it must
leave the same state and an untouched G_ema.
'''

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.BigGAN import model as jm
from animeface_tpu.implementations.BigGAN import utils as ju
from animeface_tpu.nnutils.loss import HingeLoss as JHinge
from animeface_tpu_torch.convert import convert_biggan_discriminator, convert_biggan_generator
from animeface_tpu_torch.implementations.BigGAN import utils as tu
from animeface_tpu_torch.nnutils.loss import HingeLoss
from test_torch_biggan import B, CH, S, Z, _nchw, check_state, init_vars
from test_torch_diffaugment import jax_draws
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_step import LR, _sgd_keeping_grads

RTOL = 1e-4
#: a gradient is held at RTOL of at least this share of its model's largest:
#: a conv bias before a train-mode BatchNorm has a structurally zero
#: gradient, which both frameworks leave at f32 rounding (about 1e-9)
ZERO_GRAD_FLOOR = 1e-3
POLICY = 'color,translation'
ARGS = tu.default_args(image_size=S, batch_size=B, z_dim=Z, channels=CH, no_bf16=True)


def compare_step(ports, jnew, metrics, jmetrics, convert_g, convert_d, G_ema=None):
    '''Losses, gradients and every state entry of G and D (and G_ema)
    after one step against JAX's.'''
    assert sorted(metrics) == sorted(jmetrics) == ['d', 'g']
    for k in ('g', 'd'):
        close(metrics[k], jmetrics[k], rtol=RTOL, what=f'{k} loss')
    for port, new, grads, convert in ((ports[0], jnew['G'], jnew['g_opt'], convert_g),
                                      (ports[1], jnew['D'], jnew['d_opt'], convert_d)):
        want_grad = convert(dict(new, params=grads))
        floor = ZERO_GRAD_FLOOR * max(float(v.abs().max()) for v in want_grad.values())
        for name, p in port.named_parameters():
            close(p.grad, want_grad[name], rtol=RTOL * max(
                1, floor / max(float(want_grad[name].abs().max()), 1e-30)), what=f'grad {name}')
        check_state(port, convert(new), RTOL, what='new state')
    if G_ema is not None:
        check_state(G_ema, convert_g(jnew['G_ema']), RTOL, what='G_ema')


def load(G, D, G_ema, gv, dv):
    for module, convert, v in ((G, convert_biggan_generator, gv),
                               (G_ema, convert_biggan_generator, gv),
                               (D, convert_biggan_discriminator, dv)):
        module.load_state_dict(convert(v))


@pytest.fixture(scope='module')
def jax_step():
    '''The JAX step (EMA on) from one state, its outputs and its draws.'''
    jG = jm.Generator(image_size=S, z_dim=Z, channels=CH)
    jD = jm.Discriminator(image_size=S, channels=CH)
    gv, dv = init_vars(jG, jnp.zeros((2, Z))), init_vars(jD, jnp.zeros((2, S, S, 3)), seed=1)
    sgd = _sgd_keeping_grads()
    real = np.clip(np.random.default_rng(6).standard_normal((B, S, S, 3)), -1,
                   1).astype(np.float32)
    state = dict(rng=jax.random.PRNGKey(11), G=gv, D=dv, G_ema=copy.deepcopy(gv),
                 g_opt=sgd.init(gv['params']), d_opt=sgd.init(dv['params']),
                 step=jnp.int32(0))
    step = ju.build_train_step(jG, jD, sgd, sgd, JHinge(), POLICY, use_ema=True)
    jnew, jmetrics = jax.device_get(jax.jit(step)(state, jnp.asarray(real)))
    _, zkey, ar, af, ag = jax.random.split(state['rng'], 5)
    draws = dict(z=torch.from_numpy(np.array(jax.random.normal(zkey, (B, Z)))),
                 aug_r=jax_draws(ar, real.shape, POLICY), aug_f=jax_draws(af, real.shape, POLICY),
                 aug_g=jax_draws(ag, real.shape, POLICY))
    return gv, dv, real, jnew, jmetrics, draws


@pytest.mark.parametrize('use_ema', [False, True], ids=['no-ema', 'ema'])
def test_step_matches_jax(jax_step, use_ema):
    gv, dv, real, jnew, jmetrics, draws = jax_step
    G, D, G_ema = tu.build_models(ARGS, device='cpu')
    load(G, D, G_ema, gv, dv)
    assert abs(float(G.attention.gamma)) > 0.1 and abs(float(D.attention.gamma)) > 0.1
    tstate = dict(step=0, generator=None)
    tstep = tu.build_train_step(G, D, G_ema, torch.optim.SGD(G.parameters(), lr=LR),
                                torch.optim.SGD(D.parameters(), lr=LR), HingeLoss(), POLICY,
                                use_ema)
    metrics = tstep(tstate, _nchw(real), draws)
    compare_step((G, D), jnew, metrics, jmetrics, convert_biggan_generator,
                 convert_biggan_discriminator, G_ema if use_ema else None)
    if not use_ema:
        check_state(G_ema, convert_biggan_generator(gv), 0, what='G_ema unchanged')
    assert tstate['step'] == 1


def test_recipe_training_and_sampler_on_cpu():
    '''`build_training` on the CPU with `--ema` and `--deep`: two steps with
    the default draws give finite losses, and `sample_fn` runs G_ema in
    eval mode on 16 latents.'''
    run = tu.build_training(tu.default_args(**dict(vars(ARGS), ema=True, deep=True)),
                            device='cpu')
    real = torch.rand((B, 3, S, S), generator=torch.Generator().manual_seed(1)) * 2 - 1
    for _ in range(2):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
    assert run.state['step'] == 2
    images = run.sample_fn()
    assert images.shape == (16, 3, S, S) and bool(torch.isfinite(images).all())
    assert not all(torch.equal(a, b) for a, b in zip(run.G.parameters(),
                                                     run.G_ema.parameters()))
