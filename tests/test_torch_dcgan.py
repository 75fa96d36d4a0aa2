'''The shared flax-semantics BatchNorm, the DCGAN and GAN models and the
optax-semantics RMSprop of the port against the JAX package, on the CPU in
f32.

Inputs are made from seeds with numpy and go through both sides; the
models' weights are the JAX package's, bridged by `convert.py`, with every
BatchNorm's scale, bias and running statistics moved off their init values.
Tolerances: 1e-5 of the output's scale (f32 through a few convolutions and
normalisations in two frameworks), the running statistics likewise, and
1e-6 of scale for the optimizer's parameters after 5 steps. D's logits in
eval mode: 5e-5 of their scale, because normalising by the running
statistics amplifies f32 rounding there: at 64px each framework's f32
logits lie 1.1-1.7e-5 of their scale from a float64 evaluation of the same
model.
'''

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as nn

from animeface_tpu.implementations.DCGAN import model as jdc
from animeface_tpu.implementations.GAN import model as jgan
from animeface_tpu_torch.convert import (
    convert_dcgan_discriminator, convert_dcgan_generator, convert_gan_discriminator,
    convert_gan_generator)
from animeface_tpu_torch.implementations.DCGAN import model as tdc
from animeface_tpu_torch.implementations.GAN import model as tgan
from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.optim import RMSprop

RTOL = 1e-5
EVAL_D_RTOL = 5e-5
Z = 8


def _close(got, want, rtol=RTOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f'{what}: max abs err {err} vs scale {scale}'


def _np(t):
    return t.detach().float().numpy()


def _nchw(a):
    a = np.asarray(a)
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2) if a.ndim == 4 else a))


def _nhwc(t):
    a = _np(t)
    return a.transpose(0, 2, 3, 1) if a.ndim == 4 else a


def _perturb_stats(variables, seed):
    '''Move every BatchNorm's scale, bias, mean and var off its init.'''
    rng = np.random.default_rng(seed)

    def move(path, a):
        key = str(path[-1].key)
        a = np.array(a)
        if key in ('scale', 'var'):
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if key == 'mean' or (key == 'bias' and 'BatchNorm' in str(path)):
            return (a + rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, jax.device_get(variables))


# ------------------------------------------------------------------ BatchNorm

@pytest.mark.parametrize('shape', [(6, 5), (4, 3, 5, 7)], ids=['2d', '4d'])
@pytest.mark.parametrize('eps', [1e-5, 0.8])
def test_batchnorm_matches_flax(shape, eps):
    '''Two updates in train mode (the second from the first's running
    statistics), then eval mode on the running statistics.'''
    C = shape[1]
    rng = np.random.default_rng(0)
    xs = [(rng.standard_normal(shape) * 2 + 0.5).astype(np.float32) for _ in range(3)]
    nhwc = [np.moveaxis(x, 1, -1) for x in xs]
    jbn = nn.BatchNorm(momentum=0.9, epsilon=eps)
    v = jbn.init(jax.random.PRNGKey(0), nhwc[0], use_running_average=False)
    v = {'params': {'scale': rng.uniform(0.5, 1.5, C).astype(np.float32),
                    'bias': rng.standard_normal(C).astype(np.float32)},
         'batch_stats': jax.device_get(v['batch_stats'])}
    bn = BatchNorm(C, eps=eps)
    bn.load_state_dict({'weight': torch.from_numpy(v['params']['scale']),
                        'bias': torch.from_numpy(v['params']['bias']),
                        'running_mean': torch.zeros(C), 'running_var': torch.ones(C)})
    for x, xh in zip(xs[:2], nhwc[:2]):
        want, mut = jbn.apply(v, xh, use_running_average=False, mutable=['batch_stats'])
        v = dict(v, **mut)
        _close(np.moveaxis(_np(bn(torch.from_numpy(x), train=True)), 1, -1), want,
               what='train output')
        _close(_np(bn.running_mean), v['batch_stats']['mean'], what='running mean')
        _close(_np(bn.running_var), v['batch_stats']['var'], what='running var')
    want = jbn.apply(v, nhwc[2], use_running_average=True)
    _close(np.moveaxis(_np(bn(torch.from_numpy(xs[2]), train=False)), 1, -1), want,
           what='eval output')


# ---------------------------------------------------------------------- DCGAN

def _dcgan_vars(size):
    jG, jD = jdc.Generator(latent_dim=Z, image_size=size), jdc.Discriminator(image_size=size)
    gv = jax.jit(lambda k: jG.init(k, jnp.zeros((2, Z))))(jax.random.PRNGKey(0))
    dv = jax.jit(lambda k: jD.init(k, jnp.zeros((2, size, size, 3))))(jax.random.PRNGKey(1))
    return jG, jD, _perturb_stats(gv, 1), _perturb_stats(dv, 2)


def _settled(apply_train, variables, x, seed):
    '''`variables` with every BatchNorm's running statistics near the batch
    statistics of x's train-mode pass (as a trained model's are; the init
    mean 0 and var 1 shrink D's eval-mode logits to where f32 cancellation
    rules them): zero statistics updated once at momentum 0.9 give a tenth
    of the batch's; each is then moved by up to 20%.'''
    rng = np.random.default_rng(seed)
    zero = jax.tree_util.tree_map(np.zeros_like, variables['batch_stats'])
    _, mut = apply_train(dict(variables, batch_stats=zero), x)
    stats = jax.tree_util.tree_map(
        lambda a: (np.asarray(a) / 0.1 * rng.uniform(0.8, 1.2, a.shape)).astype(np.float32),
        jax.device_get(mut['batch_stats']))
    return dict(variables, batch_stats=stats)


def _check_stats(module, new, convert, what):
    want = convert(new)
    for name, b in module.named_buffers():
        _close(_np(b), want[name].numpy(), what=f'{what} {name}')


@pytest.mark.parametrize('size', [32, 64])
@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_dcgan_models_match_jax(size, train):
    jG, jD, gv, dv = _dcgan_vars(size)
    z = np.random.default_rng(3).standard_normal((4, Z)).astype(np.float32)
    G = tdc.Generator(latent_dim=Z, image_size=size)
    D = tdc.Discriminator(image_size=size)
    G.load_state_dict(convert_dcgan_generator(gv))
    assert [c.weight.shape[1] for c in G.convs][:-1] == [512, 256, 128, 64][-len(G.norms):]
    if train:
        images, gmut = jG.apply(gv, z, train=True, mutable=['batch_stats'])
        logits, dmut = jD.apply(dv, images, train=True, mutable=['batch_stats'])
    else:
        images = np.asarray(jG.apply(gv, z, train=False))
        dv = _settled(lambda v, x: jD.apply(v, x, train=True, mutable=['batch_stats']), dv,
                      images, 8)
        logits = jD.apply(dv, images, train=False)
    got = G(torch.from_numpy(z), train=train)
    _close(_nhwc(got), images, what='G images')
    D.load_state_dict(convert_dcgan_discriminator(dv))
    _close(_np(D(_nchw(np.asarray(images)), train=train)), logits,
           rtol=RTOL if train else EVAL_D_RTOL, what='D logits')
    assert got.shape == (4, 3, size, size) and logits.shape == (4, 1)
    if train:
        _check_stats(G, dict(gv, **gmut), convert_dcgan_generator, 'G')
        _check_stats(D, dict(dv, **dmut), convert_dcgan_discriminator, 'D')


def test_dcgan_convtranspose_needs_the_flip():
    '''flax's ConvTranspose does not flip its kernel: without the
    converter's flip, G's images are off by O(1) of their scale.'''
    jG, _, gv, _ = _dcgan_vars(32)
    z = np.random.default_rng(4).standard_normal((4, Z)).astype(np.float32)
    want = np.asarray(jG.apply(gv, z, train=False))
    G = tdc.Generator(latent_dim=Z, image_size=32)
    sd = convert_dcgan_generator(gv)
    G.load_state_dict(sd)
    _close(_nhwc(G(torch.from_numpy(z), train=False)), want, what='flipped')
    G.load_state_dict({k: v.flip(2, 3) if k.startswith('convs.') else v for k, v in sd.items()})
    err = np.abs(_nhwc(G(torch.from_numpy(z), train=False)) - want).max()
    assert err > 0.1 * np.abs(want).max(), err


# ------------------------------------------------------------------------ GAN

@pytest.mark.parametrize('shape', [(8, 4, 3), (4, 6, 2)], ids=['8x4x3', '4x6x2'])
def test_gan_models_match_jax_non_square(shape):
    '''H != W and C != 3 catch an NHWC/NCHW mix-up in either Dense bridge.'''
    H, W, C = shape
    jG, jD = jgan.Generator(latent_dim=Z, image_shape=shape), jgan.Discriminator(image_shape=shape)
    gv = _perturb_stats(jG.init(jax.random.PRNGKey(0), jnp.zeros((2, Z))), 1)
    dv = jax.device_get(jD.init(jax.random.PRNGKey(1), jnp.zeros((2,) + shape)))
    z = np.random.default_rng(5).standard_normal((6, Z)).astype(np.float32)
    G = tgan.Generator(latent_dim=Z, image_shape=(C, H, W))
    D = tgan.Discriminator(image_shape=(C, H, W))
    G.load_state_dict(convert_gan_generator(gv, shape))
    D.load_state_dict(convert_gan_discriminator(dv['params'], shape))
    images, gmut = jG.apply(gv, z, train=True, mutable=['batch_stats'])
    got = G(torch.from_numpy(z))
    assert got.shape == (6, C, H, W)
    _close(_nhwc(got), images, what='G images')
    _check_stats(G, dict(gv, **gmut), lambda v: convert_gan_generator(v, shape), 'G')
    _close(_nhwc(G(torch.from_numpy(z), train=False)),
           jG.apply(dict(gv, **gmut), z, train=False), what='G eval images')
    x = np.random.default_rng(6).uniform(-1, 1, (6,) + shape).astype(np.float32)
    _close(_np(D(_nchw(x))), jD.apply(dv, x), what='D logits')


# -------------------------------------------------------------------- RMSprop

def test_rmsprop_matches_optax():
    '''5 steps of random gradients, some of them near 0 (where eps inside
    and outside the root differ most) and one exactly 0.'''
    rng = np.random.default_rng(7)
    p0 = rng.standard_normal((3, 17)).astype(np.float32)
    grads = [rng.standard_normal((3, 17)).astype(np.float32) for _ in range(5)]
    for g in grads:
        g[0] *= 1e-5
        g[1, :4] = 1e-9 * rng.standard_normal(4)
        g[2, 0] = 0.0
    tx = optax.rmsprop(5e-2)
    jp, st = jnp.asarray(p0), tx.init(jnp.asarray(p0))
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = RMSprop([p], lr=5e-2)
    for g in grads:
        up, st = tx.update(jnp.asarray(g), st, jp)
        jp = optax.apply_updates(jp, up)
        p.grad = torch.from_numpy(g)
        opt.step()
        _close(_np(p), jp, rtol=1e-6, what='parameters')
        _close(_np(opt.state[p]['nu']), st[0].nu, rtol=1e-6, what='nu')
    torch_rms = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    other = torch.optim.RMSprop([torch_rms], lr=5e-2, alpha=0.9, eps=1e-8)
    for g in grads:
        torch_rms.grad = torch.from_numpy(g)
        other.step()
    assert np.abs(_np(torch_rms) - np.asarray(jp)).max() > 1e-3    # eps outside the root
