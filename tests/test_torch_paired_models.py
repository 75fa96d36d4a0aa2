'''The paired recipes' models against the JAX package's, in f32 on the CPU:
pix2pix's UNet G and conditional patch D, SRGAN's G (instance norm,
BatchNorm, no norm; spectral norm on and off) and its multi-scale D, and
ESRGAN's RRDB G; `pixel_shuffle` against the JAX depth-to-space and
`linen.ConvTranspose` against flax's `nn.ConvTranspose` with the
converter's flipped kernel. The SR models run `train=True` twice, each
from the buffers the last left (every spectral norm's u, the running
statistics), and their state after both is held too.

Variables come from `paired_vars`: flax's tree from `jax.eval_shape`
drawn with numpy, every parameter, u and statistic off its init value.
Outputs agree within 1e-5 of their scale.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from animeface_tpu.implementations.ESRGAN import model as je
from animeface_tpu.implementations.SRGAN import model as js
from animeface_tpu.implementations.pix2pix import model as jp
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.ESRGAN import model as te
from animeface_tpu_torch.implementations.SRGAN import model as ts
from animeface_tpu_torch.implementations.pix2pix import model as tp
from animeface_tpu_torch.nnutils.module.linen import ConvTranspose
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_simple_gan_models import nchw, nhwc
from test_torch_simple_gan_steps import FAST_COMPILE

RTOL = 1e-5


def paired_vars(module, *inputs, seed=0, **kw):
    '''Variables of `module` with flax's tree (from `jax.eval_shape`, no
    compile) drawn from a seeded numpy stream: kernels N(0, 1 / fan_in),
    biases N(0, 0.1), u N(0, 1), running means N(0, 0.04), variances and
    norm scales U(0.5, 1.5), PReLU slopes U(0.1, 0.3); sigma 1.'''
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))

    def draw(path, leaf):
        key, shape = str(getattr(path[-1], 'key', path[-1])), leaf.shape
        if key.endswith('kernel'):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith('/u'):
            a = rng.standard_normal(shape)
        elif key == 'bias':
            a = rng.standard_normal(shape) * 0.1
        elif key == 'mean':
            a = rng.standard_normal(shape) * 0.2
        elif key in ('var', 'scale'):
            a = rng.uniform(0.5, 1.5, shape)
        elif key == 'negative_slope':
            a = rng.uniform(0.1, 0.3, shape)
        elif key.endswith('sigma'):
            a = np.ones(shape)
        else:
            raise KeyError(path)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def japply(module, variables, x, **kw):
    '''`module.apply(variables, x, **kw)` jitted with XLA's LLVM passes off
    (a tenth of the eager apply's op-by-op compiles).'''
    def f(v, a):
        return module.apply(v, a, **kw)
    return jax.jit(f).lower(variables, x).compile(FAST_COMPILE)(variables, x)


def _inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize('factor', [2, 3])
def test_pixel_shuffle_matches_jax(factor):
    x = _inputs((2, 3, 4, 5 * factor * factor), factor)
    close(nhwc(ts.pixel_shuffle(nchw(x), factor)), js.pixel_shuffle(jnp.asarray(x), factor),
          rtol=0, what='pixel shuffle')


@pytest.mark.parametrize('k,s', [(4, 2), (3, 1), (2, 2)])
def test_conv_transpose_matches_flax(k, s):
    '''flax's SAME transposed conv against `linen.ConvTranspose` loaded
    with the flipped kernel (`convert._conv_transpose`).'''
    x = _inputs((2, 5, 6, 3), k)
    layer = fnn.ConvTranspose(4, (k, k), strides=(s, s), padding='SAME')
    variables = paired_vars(layer, jnp.zeros((1, 5, 6, 3)), seed=k)
    want = japply(layer, variables, x)
    mine = ConvTranspose(3, 4, k, s)
    sd = {}
    convert._conv_transpose(variables['params'], 'c', sd)
    mine.load_state_dict({k_[2:]: v for k_, v in sd.items()})
    close(nhwc(mine(nchw(x))), want, rtol=RTOL, what=f'conv transpose {k}/{s}')


def test_conv_transpose_refuses_uneven_same():
    '''flax's SAME pads a 1x1 kernel at stride 2 by 0 and 1: past the
    kernel, which no crop gives (uneven SAME within it is cropped, tests/
    test_torch_restoration_models.py).'''
    with pytest.raises(ValueError, match='unevenly'):
        ConvTranspose(3, 4, 1, 2)


@pytest.mark.parametrize('drop_out', [0.0, 0.5])
def test_pix2pix_generator_matches_jax(drop_out):
    '''The UNet at 32px (five levels, widths 64-512), line art in and RGB
    out; with dropout the eval forward (no source) against flax's
    train=False, and one source's masks are the same on two calls.'''
    jG = jp.Generator(image_size=32, image_channels=3, drop_out=drop_out)
    variables = paired_vars(jG, jnp.zeros((1, 32, 32, 1)), train=False)
    G = tp.Generator(32, 3, 1, drop_out)
    G.load_state_dict(convert.convert_pix2pix_generator(variables['params']))
    x = _inputs((2, 32, 32, 1), 1)
    got = G(nchw(x))
    close(nhwc(got), japply(jG, variables, x, train=False), rtol=RTOL, what='pix2pix G')
    if drop_out:
        def masked():
            return G(nchw(x), dropout=torch.Generator().manual_seed(3))
        a = masked()
        assert torch.equal(a, masked()) and not torch.allclose(a, got)


def test_pix2pix_discriminator_matches_jax():
    jD = jp.Discriminator()
    variables = paired_vars(jD, jnp.zeros((1, 32, 32, 4)))
    D = tp.Discriminator(4)
    D.load_state_dict(convert.convert_pix2pix_discriminator(variables['params']))
    x = _inputs((2, 32, 32, 4), 2)
    close(nhwc(D(nchw(x))), japply(jD, variables, x), rtol=RTOL, what='pix2pix D')


def _twice(jmodel, variables, model, x, convert_fn, compare):
    '''`train=True` twice on both sides, each call from the buffers the
    last left; `compare(got, want, what)` holds the outputs, then the
    state after both calls is held.'''
    for call in range(2):
        want, mut = japply(jmodel, variables, x, train=True, mutable=['batch_stats'])
        variables = {'params': variables['params'], **mut}
        compare(model(nchw(x), train=True), want, f'call {call}')
    want_state = convert_fn(variables)
    state = model.state_dict()
    assert set(state) == set(want_state)
    for name, v in state.items():
        close(v.numpy(), want_state[name].numpy(), rtol=RTOL, what=f'state {name}')


def _image(got, want, what):
    close(nhwc(got), want, rtol=RTOL, what=what)


@pytest.mark.parametrize('norm,sn', [('in', True), ('bn', True), ('', False)])
def test_srgan_generator_matches_jax(norm, sn):
    kw = dict(channels=8, num_blocks=2, norm_name=norm, sn=sn)
    jG = js.Generator(**kw)
    variables = paired_vars(jG, jnp.zeros((2, 8, 8, 3)), train=True)
    if not sn:
        assert 'batch_stats' not in variables
        variables = dict(variables, batch_stats={})
    G = ts.Generator(**kw)
    G.load_state_dict(convert.convert_srgan_generator(variables))
    _twice(jG, variables, G, _inputs((2, 8, 8, 3), 3), convert.convert_srgan_generator, _image)


@pytest.mark.parametrize('act', ['prelu', 'lrelu'])
def test_srgan_discriminator_matches_jax(act):
    '''Two scales of two layers on 32px, each scale's logits and
    activations.'''
    kw = dict(channels=4, num_layers=2, act_name=act)
    jD = js.Discriminator(**kw)
    variables = paired_vars(jD, jnp.zeros((2, 32, 32, 3)), train=True)
    D = ts.Discriminator(**kw)
    D.load_state_dict(convert.convert_srgan_discriminator(variables))

    def compare(got, want, what):
        assert len(got) == len(want) == 2
        for s, ((logits, feats), (jlogits, jfeats)) in enumerate(zip(got, want)):
            _image(logits, jlogits, f'{what} scale {s} logits')
            assert len(feats) == len(jfeats) == 3
            for i, (f, jf) in enumerate(zip(feats, jfeats)):
                _image(f, jf, f'{what} scale {s} act {i}')
    _twice(jD, variables, D, _inputs((2, 32, 32, 3), 4), convert.convert_srgan_discriminator,
           compare)


def test_esrgan_generator_matches_jax():
    kw = dict(channels=8, hid_channels=4, num_rrdb=2, num_rd=2, num_conv=3)
    jG = je.Generator(**kw)
    variables = paired_vars(jG, jnp.zeros((2, 8, 8, 3)), train=True)
    G = te.Generator(**kw)
    G.load_state_dict(convert.convert_esrgan_generator(variables))
    _twice(jG, variables, G, _inputs((2, 8, 8, 3), 5), convert.convert_esrgan_generator, _image)


def test_esrgan_residual_stream_is_f32_in_bf16():
    '''JAX's numpy float64 divisor promotes the bf16 stream to float32;
    the port's RRDB returns float32 in a bf16 model too.'''
    block = te.RRDB(4, 2, 1, 3, dtype=torch.bfloat16)
    assert block(torch.zeros((1, 4, 4, 4), dtype=torch.bfloat16)).dtype == torch.float32
    jblock = je.RRDB(4, 2, 1, 3, dtype=jnp.bfloat16)
    variables = paired_vars(jblock, jnp.zeros((1, 4, 4, 4), jnp.bfloat16), train=True)
    assert japply(jblock, variables, jnp.zeros((1, 4, 4, 4), jnp.bfloat16),
                  train=False).dtype == jnp.float32
