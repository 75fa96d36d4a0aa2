'''One training step of DCGAN, GAN, WGAN (critic and full) and WGAN-gp
(critic and full) of the port against the JAX steps, and the assembled
recipes on the CPU.

Both sides start from one bridged state (the JAX package's G and D at
32px, GAN's at 16px, with every BatchNorm's scale, bias and running
statistics moved off their init values; batch 8, f32 on the CPU) and get
the same draws: z from the step's `zkey`, and WGAN-gp's alpha from its
`akey` (`WGAN_gp/utils.py:45`). The step runs plain SGD on both sides (WGAN
keeps its clipping) and each keeps the raw gradients (JAX in the optimizer
state, the port in `.grad`). Everything the step leaves (losses, gradients,
parameters, BatchNorm running statistics) is compared at 1e-4 of its
scale, the tolerance of `tests/test_torch_fastgan_step.py` (f32 through G
and D, forward and backward, in two frameworks).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.DCGAN import model as jdc
from animeface_tpu.implementations.DCGAN import utils as jdu
from animeface_tpu.implementations.GAN import model as jgan
from animeface_tpu.implementations.GAN import utils as jgu
from animeface_tpu.implementations.WGAN import utils as jwu
from animeface_tpu.implementations.WGAN_gp import utils as jwgu
from animeface_tpu.nnutils.loss import GANLoss as JGANLoss, WGANLoss as JWGANLoss
from animeface_tpu_torch.convert import (
    convert_dcgan_discriminator, convert_dcgan_generator, convert_gan_discriminator,
    convert_gan_generator)
from animeface_tpu_torch.implementations.DCGAN import utils as tdu
from animeface_tpu_torch.implementations.GAN import utils as tgu
from animeface_tpu_torch.implementations.WGAN import utils as twu
from animeface_tpu_torch.implementations.WGAN_gp import utils as twgu
from animeface_tpu_torch.nnutils.loss import GANLoss, WGANLoss
from test_torch_dcgan import _perturb_stats
from test_torch_step import _sgd_keeping_grads, _close, _nchw, LR

RTOL = 1e-4
B, Z = 8, 8
CLIP = 0.01


def _real(size, seed=6):
    return np.clip(np.random.default_rng(seed).standard_normal((B, size, size, 3)), -1,
                   1).astype(np.float32)


def _dcgan_setup(size=32):
    jG, jD = jdc.Generator(latent_dim=Z, image_size=size), jdc.Discriminator(image_size=size)
    gv = jax.jit(lambda k: jG.init(k, jnp.zeros((2, Z))))(jax.random.PRNGKey(0))
    dv = jax.jit(lambda k: jD.init(k, jnp.zeros((2, size, size, 3))))(jax.random.PRNGKey(1))
    return jG, jD, _perturb_stats(gv, 1), _perturb_stats(dv, 2)


def _jax_step(step, gv, dv, real, rng=11):
    sgd = _sgd_keeping_grads()
    state = dict(rng=jax.random.PRNGKey(rng), G=gv, D=dv, g_opt=sgd.init(gv['params']),
                 d_opt=sgd.init(dv['params']), step=jnp.int32(0))
    new, metrics = jax.device_get(jax.jit(step)(state, jnp.asarray(real)))
    return state['rng'], new, metrics


def _check(port, new_vars, grads, convert, what):
    '''Gradients, then every entry of the state dict (parameters and
    running statistics) against the JAX step's. A dense layer's bias right
    before a BatchNorm has a zero gradient in exact arithmetic (the norm
    subtracts it again), so both frameworks give rounding noise there:
    each gradient is held to RTOL of its own scale or of 1e-2 of the
    module's largest gradient, whichever is larger.'''
    want_grad = convert(dict(new_vars, params=grads))
    floor = 1e-2 * max(float(want_grad[n].abs().max()) for n, _ in port.named_parameters())
    for name, p in port.named_parameters():
        assert p.grad is not None, f'{what}: no gradient for {name}'
        scale = max(float(want_grad[name].abs().max()), floor)
        err = float((p.grad - want_grad[name]).abs().max())
        assert err <= RTOL * scale, f'{what} grad {name}: max abs err {err} vs scale {scale}'
    want = convert(new_vars)
    got = port.state_dict()
    assert set(got) == set(want)
    for name, v in got.items():
        _close(v.numpy(), want[name].numpy(), rtol=RTOL, what=f'{what} {name}')


def _port_models(build_models, args, gv, dv, convert_g, convert_d):
    G, D = build_models(args, device='cpu')
    G.load_state_dict(convert_g(gv))
    D.load_state_dict(convert_d(dv))
    return G, D, torch.optim.SGD(G.parameters(), lr=LR), torch.optim.SGD(D.parameters(), lr=LR)


def _z(zkey):
    return torch.from_numpy(np.array(jax.random.normal(zkey, (B, Z))))


def test_dcgan_step_matches_jax():
    jG, jD, gv, dv = _dcgan_setup()
    sgd = _sgd_keeping_grads()
    real = _real(32)
    rng, new, jm = _jax_step(jdu.build_train_step(jG, jD, sgd, sgd, JGANLoss()), gv, dv, real)
    _, zkey = jax.random.split(rng)
    args = tdu.default_args(image_size=32, latent_dim=Z, no_bf16=True)
    G, D, g_opt, d_opt = _port_models(tdu.build_models, args, gv, dv, convert_dcgan_generator,
                                      convert_dcgan_discriminator)
    state = dict(step=0, generator=None)
    metrics = tdu.build_train_step(G, D, g_opt, d_opt, GANLoss())(state, _nchw(real),
                                                                  dict(z=_z(zkey)))
    for k in ('d', 'g'):
        _close(metrics[k], jm[k], rtol=RTOL, what=f'{k} loss')
    _check(G, new['G'], new['g_opt'], convert_dcgan_generator, 'G')
    _check(D, new['D'], new['d_opt'], convert_dcgan_discriminator, 'D')
    assert state['step'] == 1


def test_gan_step_matches_jax():
    size = 16
    shape = (size, size, 3)
    jG, jD = jgan.Generator(latent_dim=Z, image_shape=shape), jgan.Discriminator(image_shape=shape)
    gv = _perturb_stats(jG.init(jax.random.PRNGKey(0), jnp.zeros((2, Z))), 1)
    dv = jax.device_get(jD.init(jax.random.PRNGKey(1), jnp.zeros((2,) + shape)))
    sgd = _sgd_keeping_grads()
    real = _real(size)
    rng, new, jm = _jax_step(jgu.build_train_step(jG, jD, sgd, sgd, JGANLoss()), gv, dv, real)
    _, zkey = jax.random.split(rng)
    args = tgu.default_args(image_size=size, latent_dim=Z, no_bf16=True)
    G, D, g_opt, d_opt = _port_models(
        tgu.build_models, args, gv, dv, lambda v: convert_gan_generator(v, shape),
        lambda v: convert_gan_discriminator(v['params'], shape))
    metrics = tdu.build_train_step(G, D, g_opt, d_opt, GANLoss())(
        dict(step=0, generator=None), _nchw(real), dict(z=_z(zkey)))
    for k in ('d', 'g'):
        _close(metrics[k], jm[k], rtol=RTOL, what=f'{k} loss')
    _check(G, new['G'], new['g_opt'], lambda v: convert_gan_generator(v, shape), 'G')
    _check(D, new['D'], new['d_opt'],
           lambda v: convert_gan_discriminator(v['params'], shape), 'D')


@pytest.mark.parametrize('recipe', ['WGAN', 'WGAN_gp'])
@pytest.mark.parametrize('variant', ['critic', 'full'])
def test_wgan_steps_match_jax(recipe, variant):
    '''A critic step keeps neither G's update nor its BatchNorm updates; a
    full step keeps both. WGAN clips every D parameter to +-0.01 after
    D's update; WGAN-gp adds the per-sample penalty with the same alpha.'''
    jG, jD, gv, dv = _dcgan_setup()
    sgd = _sgd_keeping_grads()
    real = _real(32)
    if recipe == 'WGAN':
        jsteps = jwu.build_steps(jG, jD, sgd, sgd, JWGANLoss(), CLIP)
    else:
        jsteps = jwgu.build_steps(jG, jD, sgd, sgd, JWGANLoss(), 10.0)
    rng, new, jm = _jax_step(jsteps[variant == 'full'], gv, dv, real)
    keys = jax.random.split(rng, 2 if recipe == 'WGAN' else 3)
    draws = dict(z=_z(keys[1]))
    tu = twu if recipe == 'WGAN' else twgu
    args = tu.default_args(image_size=32, latent_dim=Z, no_bf16=True)
    G, D, g_opt, d_opt = _port_models(tdu.build_models, args, gv, dv, convert_dcgan_generator,
                                      convert_dcgan_discriminator)
    if recipe == 'WGAN':
        steps = twu.build_steps(G, D, g_opt, d_opt, WGANLoss(), CLIP)
    else:
        steps = twgu.build_steps(G, D, g_opt, d_opt, WGANLoss(), 10.0)
        draws['alpha'] = torch.from_numpy(np.array(jax.random.uniform(keys[2], (B, 1, 1, 1))))
    state = dict(step=0, generator=None)
    metrics = steps[variant](state, _nchw(real), draws)
    for k in ('d', 'g'):
        _close(metrics[k], jm[k], rtol=RTOL, what=f'{k} loss')
    if variant == 'critic':
        assert float(metrics['g']) == 0.0
        want = convert_dcgan_generator(new['G'])        # G and its statistics as they were
        assert all(torch.equal(v, want[k]) for k, v in G.state_dict().items())
        assert all(p.grad is None for p in G.parameters())
        _check(D, new['D'], new['d_opt'], convert_dcgan_discriminator, 'D')
    else:
        _check(G, new['G'], new['g_opt'], convert_dcgan_generator, 'G')
        _check(D, new['D'], new['d_opt'], convert_dcgan_discriminator, 'D')
    if recipe == 'WGAN':
        assert max(float(p.abs().max()) for p in D.parameters()) <= CLIP
    assert state['step'] == 1


@pytest.mark.parametrize('recipe', ['DCGAN', 'GAN', 'WGAN', 'WGAN_gp'])
def test_recipe_training_on_cpu(recipe):
    '''`build_training` on the CPU: 5 steps with the default draws give
    finite losses, WGAN's variants follow (i + 1) % n_critic with g = 0 on
    the critic steps, WGAN's D stays within +-clip_value, and G samples in
    eval mode.'''
    tu = dict(DCGAN=tdu, GAN=tgu, WGAN=twu, WGAN_gp=twgu)[recipe]
    args = tu.default_args(image_size=16, latent_dim=Z)
    run = tu.build_training(args, device='cpu')
    real = torch.rand((B, 3, 16, 16), generator=torch.Generator().manual_seed(1)) * 2 - 1
    gs = []
    for _ in range(5):
        metrics = run.train_step(run.state, real)
        assert all(bool(torch.isfinite(v)) for v in metrics.values())
        gs.append(float(metrics['g']))
    assert run.state['step'] == 5
    if recipe.startswith('WGAN'):
        assert [g != 0 for g in gs] == [False] * 4 + [True]
    if recipe == 'WGAN':
        assert max(float(p.abs().max()) for p in run.D.parameters()) <= args.clip_value
    with torch.no_grad():
        images = run.G(torch.randn(4, Z), train=False)
    assert images.shape == (4, 3, 16, 16) and bool(torch.isfinite(images).all())


@pytest.mark.parametrize('recipe', ['DCGAN', 'GAN', 'WGAN', 'WGAN_gp'])
def test_build_training_refuses_a_missing_card(monkeypatch, recipe):
    tu = dict(DCGAN=tdu, GAN=tgu, WGAN=twu, WGAN_gp=twgu)[recipe]
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        tu.build_training(tu.default_args(image_size=16, latent_dim=Z))
