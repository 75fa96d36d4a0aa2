'''StyleGAN2 in the port against the JAX package, through the weight bridge.

Small model (32px, style 16, channels 8..32, 2 mapping layers, batch 8, so
the minibatch-stddev runs 2 strided groups), f32 on the CPU. Tolerance
1e-4 relative: the two frameworks run the same f32 convolutions and
matmuls with other summation orders through ~20 layers, and the
demodulation's rsqrt and the tanh amplify last-bit differences a little.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from animeface_tpu.implementations.StyleGAN2 import model as jm
from animeface_tpu.implementations.StyleGAN2.utils import pl_lengths as j_pl_lengths
from animeface_tpu.nnutils.loss import r1_regularizer as j_r1
from animeface_tpu_torch.convert import convert_generator, convert_discriminator
from animeface_tpu_torch.implementations.StyleGAN2 import model as tm
from animeface_tpu_torch.implementations.StyleGAN2.utils import pl_lengths
from animeface_tpu_torch.nnutils.loss import r1_regularizer

CFG = dict(image_size=32, style_dim=16, channels=8, max_channels=32)
B = 8
RTOL = 1e-4


def _close(got, want, rtol=RTOL):
    got = np.asarray(got)
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1e-6)
    assert np.abs(got - want).max() <= rtol * scale, \
        f'max abs err {np.abs(got - want).max()} vs scale {scale}'


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope='module')
def models():
    jG = jm.Generator(map_num_layers=2, **CFG)
    jD = jm.Discriminator(image_size=32, channels=8, max_channels=32)
    k = jax.random.PRNGKey(0)
    gp = jax.device_get(jax.jit(jG.init)({'params': k, 'noise': k, 'mixing': k},
                                         jnp.zeros((1, 16)))['params'])
    dp = jax.device_get(jax.jit(jD.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((1, 32, 32, 3)))['params'])
    # non-zero biases so the bridge's bias mapping is exercised
    rng = np.random.default_rng(0)
    gp, dp = [jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.standard_normal(a.shape).astype(np.float32) * 0.1
                         if path[-1].key == 'bias' else np.asarray(a)), p)
              for p in (gp, dp)]
    tG = tm.Generator(map_num_layers=2, **CFG)
    tD = tm.Discriminator(image_size=32, channels=8, max_channels=32)
    tG.load_state_dict(convert_generator(gp))
    tD.load_state_dict(convert_discriminator(dp))
    return jG, gp, tG, jD, dp, tD


def _z(seed=0):
    return np.random.default_rng(seed).standard_normal((B, 16)).astype(np.float32)


def _capture_noise(jG, gp, z, key, method=None):
    '''Run JAX G with a 'noise' rng and record the maps its InjectNoise
    layers draw (identical draws: the interceptor makes the same make_rng
    call the module would).'''
    maps = []

    def interceptor(next_fun, args, kwargs, context):
        if isinstance(context.module, jm.InjectNoise) and context.method_name == '__call__':
            x = args[0]
            noise = jax.random.normal(context.module.make_rng('noise'),
                                      x.shape[:3] + (1,), x.dtype)
            maps.append(np.asarray(noise))
            return x + noise
        return next_fun(*args, **kwargs)

    with fnn.intercept_methods(interceptor):
        out = jG.apply({'params': gp}, z, rngs={'noise': key},
                       **({} if method is None else {'method': method}))
    return out, [_nchw(m) for m in maps]


def test_bridge_covers_every_parameter(models):
    jG, gp, tG, jD, dp, tD = models
    n_jax = sum(np.size(a) for a in jax.tree_util.tree_leaves((gp, dp)))
    n_port = sum(p.numel() for p in list(tG.parameters()) + list(tD.parameters()))
    assert n_jax == n_port


def test_generator_forward_no_noise(models):
    jG, gp, tG, *_ = models
    z = _z()
    jimg, jw = jG.apply({'params': gp}, jnp.asarray(z))
    timg, tw = tG(torch.from_numpy(z))
    _close(_nhwc(timg), jimg)
    _close(tw.detach().numpy(), jw)


def test_generator_forward_injected_noise(models):
    jG, gp, tG, *_ = models
    z = _z(1)
    (jimg, _), maps = _capture_noise(jG, gp, jnp.asarray(z), jax.random.PRNGKey(7))
    assert [tuple(m.shape) for m in maps] == tG.noise_shapes(B)
    timg, _ = tG(torch.from_numpy(z), noise=maps)
    _close(_nhwc(timg), jimg)


def test_generator_unfused_resample_and_mixing():
    '''The reference-exact resampling path (separate bilinear up + blur) and
    style mixing with a fixed injection layer.'''
    jG = jm.Generator(map_num_layers=2, fused_resample=False, **CFG)
    k = jax.random.PRNGKey(3)
    gp = jax.device_get(jax.jit(jG.init)({'params': k, 'noise': k, 'mixing': k},
                                         jnp.zeros((1, 16)))['params'])
    tG = tm.Generator(map_num_layers=2, fused_resample=False, **CFG)
    tG.load_state_dict(convert_generator(gp))
    z1, z2 = _z(2), _z(3)
    jimg, _ = jG.apply({'params': gp}, (jnp.asarray(z1), jnp.asarray(z2)), injection=2)
    timg, _ = tG((torch.from_numpy(z1), torch.from_numpy(z2)), injection=2)
    _close(_nhwc(timg), jimg)


def test_discriminator_forward_and_stacked_pass(models):
    *_, jD, dp, tD = models
    rng = np.random.default_rng(4)
    real = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    fake = rng.standard_normal((B, 32, 32, 3)).astype(np.float32)
    jr = jD.apply({'params': dp}, jnp.asarray(real))
    jf = jD.apply({'params': dp}, jnp.asarray(fake))
    _close(tD(_nchw(real)).detach().numpy(), jr)
    both = tD(torch.cat([_nchw(real), _nchw(fake)]), splits=2).detach().numpy()
    _close(both[:B], jr)
    _close(both[B:], jf)


def test_parameter_gradients(models):
    '''d/dparams of a scalar through G then D, on both sides.'''
    jG, gp, tG, jD, dp, tD = models
    z = _z(5)
    (_, _), maps = _capture_noise(jG, gp, jnp.asarray(z), jax.random.PRNGKey(9))

    def jloss(gp, dp):
        img, _ = jG.apply({'params': gp}, jnp.asarray(z), rngs={'noise': jax.random.PRNGKey(9)})
        return jnp.mean(jax.nn.softplus(-jD.apply({'params': dp}, img)))

    jl, (jgg, jdg) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(gp, dp)
    tG.zero_grad()
    tD.zero_grad()
    img, _ = tG(torch.from_numpy(z), noise=maps)
    tl = torch.nn.functional.softplus(-tD(img)).mean()
    tl.backward()
    _close(tl.item(), jl)
    for port, jgrads, convert in ((tG, jgg, convert_generator),
                                  (tD, jdg, convert_discriminator)):
        want = convert(jax.device_get(jgrads))
        for name, p in port.named_parameters():
            _close(p.grad.numpy(), want[name].numpy(), rtol=2 * RTOL)


def test_pl_lengths_and_r1(models):
    jG, gp, tG, jD, dp, tD = models
    z = _z(6)
    key = jax.random.PRNGKey(11)
    w = jG.apply({'params': gp}, jnp.asarray(z), method=jm.Generator.map_w)
    want = jax.jit(lambda w: j_pl_lengths(jG, gp, w, {'noise': key}))(w)
    _, maps = _capture_noise(jG, gp, w, key, method=jm.Generator.synthesize_from_w)
    pl_noise = jax.random.normal(jax.random.fold_in(key, 1), (B, 32, 32, 3)) / np.sqrt(32 * 32)
    got = pl_lengths(tG, torch.from_numpy(np.asarray(w)), maps, _nchw(pl_noise))
    _close(got.detach().numpy(), want)

    real = np.random.default_rng(7).standard_normal((B, 32, 32, 3)).astype(np.float32)
    want = jax.jit(lambda r: j_r1(r, lambda x: jD.apply({'params': dp}, x)))(jnp.asarray(real))
    _close(r1_regularizer(_nchw(real), tD).item(), want)
