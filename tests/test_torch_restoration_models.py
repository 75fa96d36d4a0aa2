'''The line-art recipes' models and helpers against the JAX package's, in
f32 on the CPU: `pixel_unshuffle` against the JAX space-to-depth,
`linen.ConvTranspose` where flax's SAME pads unevenly (cropped) against
`nn.ConvTranspose`, `get_normalization` for each name against the flax
module it names, the two learning-rate schedules against optax step by
step, and the G and D of NAFNet, Restormer, pix2pixHD and CycleGAN
against flax with the converters' state dicts. A model with running
statistics or spectral norm runs `train=True` twice on both sides, each
call from the buffers the last left, and its state after both is held.

Variables come from `line_art_vars`: flax's tree from `jax.eval_shape`
drawn with numpy, every parameter, u and statistic off its init value (the
layer scales at U(0.3, 0.6), so each block's branch weighs). Outputs agree
within RTOL (1e-5) of their scale; a schedule within 1e-6 of the rate.
'''

import numpy as np
import optax
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from animeface_tpu.implementations.CycleGAN import model as jc
from animeface_tpu.implementations.CycleGAN import utils as jcu
from animeface_tpu.implementations.NAFNet import model as jn
from animeface_tpu.implementations.Restormer import model as jr
from animeface_tpu.implementations.pix2pixHD import model as jh
from animeface_tpu.implementations.pix2pixHD import utils as jhu
from animeface_tpu.nnutils.module.layers import get_normalization as j_get_normalization
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.CycleGAN import model as tc
from animeface_tpu_torch.implementations.CycleGAN import utils as tcu
from animeface_tpu_torch.implementations.NAFNet import model as tn
from animeface_tpu_torch.implementations.Restormer import model as tr
from animeface_tpu_torch.implementations.pix2pixHD import model as th
from animeface_tpu_torch.implementations.pix2pixHD import utils as thu
from animeface_tpu_torch.nnutils.module.layers import get_normalization
from animeface_tpu_torch.nnutils.module.linen import ConvTranspose
from animeface_tpu_torch.nnutils.optim import scheduled
from test_torch_paired_models import japply
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_simple_gan_models import nchw, nhwc

RTOL = 1e-5
#: the scalar parameters of the blocks (layer scales, Restormer's temperature)
SCALARS = ('layer_scale1', 'layer_scale2', 'attn_scale', 'ff_scale', 'temperature')


def line_art_vars(module, *inputs, seed=0, **kw):
    '''Variables of `module` with flax's tree (from `jax.eval_shape`, no
    compile) drawn from a seeded numpy stream: kernels N(0, 1 / fan_in),
    biases N(0, 0.1), u N(0, 1), running means N(0, 0.04), variances and
    norm scales U(0.5, 1.5), the blocks' scalars U(0.3, 0.6); sigma 1.'''
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
        elif key in SCALARS:
            a = rng.uniform(0.3, 0.6, shape)
        elif key.endswith('sigma'):
            a = np.ones(shape)
        else:
            raise KeyError(path)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def inputs(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _images(got, want, what):
    close(nhwc(got), want, rtol=RTOL, what=what)


def _twice(jmodel, variables, model, x, convert_fn, compare, **kw):
    '''`train=True` twice on both sides, each call from the buffers the last
    left; `compare(got, want, what)` holds the outputs, then the state after
    both calls, which it returns (flax's variables).'''
    for call in range(2):
        want, mut = japply(jmodel, variables, x, train=True, mutable=['batch_stats'], **kw)
        variables = {'params': variables['params'], **mut}
        compare(model(nchw(x), train=True), want, f'call {call}')
    want_state = convert_fn(variables)
    state = model.state_dict()
    assert set(state) == set(want_state)
    for name, v in state.items():
        close(v.numpy(), want_state[name].numpy(), rtol=RTOL, what=f'state {name}')
    return variables


@pytest.mark.parametrize('factor', [2, 3])
def test_pixel_unshuffle_matches_jax(factor):
    x = inputs((2, 3 * factor, 4 * factor, 5), factor)
    close(nhwc(tn.pixel_unshuffle(nchw(x), factor)), jn.pixel_unshuffle(jnp.asarray(x), factor),
          rtol=0, what='pixel unshuffle')
    assert not torch.equal(tn.pixel_unshuffle(nchw(x), factor),
                           torch.nn.functional.pixel_unshuffle(nchw(x), factor))


@pytest.mark.parametrize('k,s', [(3, 2), (4, 1), (5, 2)])
def test_uneven_conv_transpose_matches_flax(k, s):
    '''flax's SAME transposed conv where it pads more before than after
    (3x3 at stride 2: 2 and 1) against `linen.ConvTranspose`'s crop.'''
    x = inputs((2, 5, 6, 3), k)
    layer = fnn.ConvTranspose(4, (k, k), strides=(s, s), padding='SAME')
    variables = line_art_vars(layer, jnp.zeros((1, 5, 6, 3)), seed=k)
    mine = ConvTranspose(3, 4, k, s)
    assert mine.crop != (0, 0)
    sd = {}
    convert._conv_transpose(variables['params'], 'c', sd)
    mine.load_state_dict({k_[2:]: v for k_, v in sd.items()})
    close(nhwc(mine(nchw(x))), japply(layer, variables, x), rtol=RTOL,
          what=f'conv transpose {k}/{s}')


@pytest.mark.parametrize('name', ['in', 'bn', 'ln', 'gn'])
def test_get_normalization_matches_flax(name):
    '''Each name's module on the same input and parameters; 'bn' on batch
    statistics, its running ones moved as flax's.'''
    C = 64
    x = inputs((3, 4, 5, C), 1) * 2 + 0.5
    jnorm = j_get_normalization(name, C)
    variables = line_art_vars(jnorm, jnp.zeros((3, 4, 5, C)), seed=2)
    mine = get_normalization(name, C)
    state = {}
    if 'params' in variables:
        state.update(weight=torch.from_numpy(np.asarray(variables['params']['scale'])),
                     bias=torch.from_numpy(np.asarray(variables['params']['bias'])))
    assert set(state) == {n for n, _ in mine.named_parameters()}
    if name == 'bn':
        s = variables['batch_stats']
        state.update(running_mean=torch.from_numpy(np.asarray(s['mean'])),
                     running_var=torch.from_numpy(np.asarray(s['var'])))
        want, mut = japply(jnorm, variables, x, mutable=['batch_stats'])
    else:
        want = japply(jnorm, variables, x)
    mine.load_state_dict(state)
    close(nhwc(mine(nchw(x))), want, rtol=RTOL, what=name)
    if name == 'bn':
        for port, flax in (('running_mean', 'mean'), ('running_var', 'var')):
            close(getattr(mine, port).numpy(), mut['batch_stats'][flax], rtol=RTOL, what=port)


@pytest.mark.parametrize('epochs,decay_epochs,spe', [(3, 4, 5), (2, 0, 3), (1, 1000, 2)])
def test_cyclegan_schedule_matches_optax(epochs, decay_epochs, spe):
    args = tcu.default_args(epochs=epochs, decay_epochs=decay_epochs)
    want = jcu.make_decay_schedule(args, spe)
    got = tcu.make_decay_schedule(args, spe)
    for count in range(spe * (epochs + min(decay_epochs, 6) + 2)):
        close(got(count), float(want(jnp.int32(count))), rtol=1e-6, what=f'count {count}')


@pytest.mark.parametrize('max_iters,spe', [(40, 4), (37, 5), (7, 1), (3, 8)])
def test_pix2pixhd_schedule_matches_jax(max_iters, spe):
    '''The rates at each count, then the rate `scheduled` gives each step
    against optax's `scale_by_schedule` on the same schedule, update by
    update (the count of updates before each).'''
    want = jhu._decay_schedule(2e-4, max_iters, spe)
    got = thu.decay_schedule(2e-4, max_iters, spe)
    for count in range(max_iters + 2 * spe):
        close(got(count), float(want(jnp.int32(count))), rtol=1e-6, what=f'count {count}')
    tx = optax.scale_by_schedule(want)
    opt_state, update_fn = tx.init(jnp.zeros(())), jax.jit(tx.update)
    sgd = torch.optim.SGD([torch.nn.Parameter(torch.zeros(()))], lr=0.0)

    def count_step(state, batch, draws=None):
        state['step'] += 1
    step, state = scheduled(count_step, (sgd,), got), dict(step=0)
    for count in range(max_iters + spe):
        update, opt_state = update_fn(jnp.ones(()), opt_state)
        step(state, None)
        close(sgd.param_groups[0]['lr'], float(update), rtol=1e-6, what=f'update {count}')


@pytest.mark.parametrize('norm,act', [('ln', None), ('in', 'sigmoid')])
def test_nafnet_generator_matches_jax(norm, act):
    '''Two levels (32px to 8px), one block each and one in the middle.'''
    kw = dict(image_size=32, bottom=8, channels=8, blocks_per_scale=1, mid_blocks=1,
              norm_name=norm, act_name=act)
    jG = jn.NAFNet(**kw)
    variables = line_art_vars(jG, jnp.zeros((1, 32, 32, 1)))
    G = tn.NAFNet(**kw)
    G.load_state_dict(convert.convert_nafnet_generator(variables['params']))
    x = inputs((2, 32, 32, 1), 3)
    _images(G(nchw(x)), japply(jG, variables, x), 'NAFNet G')


@pytest.mark.parametrize('norm', ['bn', 'ln'])
def test_nafnet_discriminator_matches_jax(norm):
    kw = dict(num_layers=3, channels=8, norm_name=norm)
    jD = jn.Discriminator(**kw)
    variables = line_art_vars(jD, jnp.zeros((2, 32, 32, 4)), train=True)
    variables.setdefault('batch_stats', {})
    D = tn.Discriminator(4, **kw)
    D.load_state_dict(convert.convert_nafnet_discriminator(variables))
    variables = _twice(jD, variables, D, inputs((4, 32, 32, 4), 4),
                       convert.convert_nafnet_discriminator, _images)
    if norm == 'bn':
        x = inputs((2, 32, 32, 4), 5)
        _images(D(nchw(x), train=False), japply(jD, variables, x, train=False), 'eval')


@pytest.mark.parametrize('skip', [False, True])
def test_restormer_generator_matches_jax(skip):
    '''Three levels (16px to 4px), one block each, one refinement block.'''
    kw = dict(num_blocks=(1, 1, 1), num_heads=(1, 2, 2), num_refinement_blocks=1, channels=8,
              skip_input=skip)
    jG = jr.Generator(**kw)
    variables = line_art_vars(jG, jnp.zeros((1, 16, 16, 1)))
    G = tr.Generator(**kw)
    G.load_state_dict(convert.convert_restormer_generator(variables['params']))
    x = inputs((2, 16, 16, 1), 6)
    _images(G(nchw(x)), japply(jG, variables, x), 'Restormer G')


PIX2PIXHD_G = dict(channels=4, local_num_blocks=1, global_num_blocks=1, global_num_downs=1)


def test_pix2pixhd_generator_matches_jax():
    '''Both images of the full forward at 32px (the global G at 16px) and
    `global_forward` on a 16px input.'''
    jG = jh.Generator(**PIX2PIXHD_G)
    variables = line_art_vars(jG, jnp.zeros((1, 32, 32, 1)))
    G = th.Generator(**PIX2PIXHD_G)
    G.load_state_dict(convert.convert_pix2pixhd_generator(variables['params']))
    x = inputs((2, 32, 32, 1), 7)
    (local, glob), (jlocal, jglob) = G(nchw(x)), japply(jG, variables, x)
    _images(local, jlocal, 'pix2pixHD local image')
    _images(glob, jglob, 'pix2pixHD global image')
    half = x[:, ::2, ::2]
    _images(G.global_forward(nchw(half)),
            japply(jG, variables, half, method=jh.Generator.global_forward), 'global_forward')


def test_pix2pixhd_discriminator_matches_jax():
    '''Three scales on 32px: each scale's logits and its four features; the
    first two alone with `num_scales=2`.'''
    jD = jh.Discriminator(channels=4)
    variables = line_art_vars(jD, jnp.zeros((1, 32, 32, 4)))
    D = th.Discriminator(4, channels=4)
    D.load_state_dict(convert.convert_pix2pixhd_discriminator(variables['params']))
    x = inputs((2, 32, 32, 4), 8)
    want = japply(jD, variables, x)
    for label, got in (('all', D(nchw(x))), ('two', D(nchw(x), 2))):
        assert len(got) == (3 if label == 'all' else 2)
        for s, ((logits, feats), (jlogits, jfeats)) in enumerate(zip(got, want)):
            _images(logits, jlogits, f'{label} scale {s} logits')
            assert len(feats) == len(jfeats) == 4
            for i, (f, jf) in enumerate(zip(feats, jfeats)):
                _images(f, jf, f'{label} scale {s} feature {i}')


@pytest.mark.parametrize('sn', [True, False])
def test_cyclegan_generator_matches_jax(sn):
    '''One down (16px to 8px), one residual block; line art to RGB.'''
    kw = dict(image_size=16, in_channels=1, out_channels=3, target_resl=8, channels=4,
              num_blocks=1, use_sn=sn)
    jG = jc.Generator(**kw)
    variables = line_art_vars(jG, jnp.zeros((2, 16, 16, 1)), train=True)
    variables.setdefault('batch_stats', {})
    G = tc.Generator(**kw)
    G.load_state_dict(convert.convert_cyclegan_generator(variables))
    _twice(jG, variables, G, inputs((2, 16, 16, 1), 9), convert.convert_cyclegan_generator,
           _images)


@pytest.mark.parametrize('norm', ['in', 'bn'])
def test_cyclegan_discriminator_matches_jax(norm):
    kw = dict(channels=4, num_layers=3, norm_name=norm, use_sn=True)
    jD = jc.Discriminator(**kw)
    variables = line_art_vars(jD, jnp.zeros((2, 32, 32, 3)), train=True)
    D = tc.Discriminator(3, **kw)
    D.load_state_dict(convert.convert_cyclegan_discriminator(variables))
    _twice(jD, variables, D, inputs((3, 32, 32, 3), 10), convert.convert_cyclegan_discriminator,
           _images)
