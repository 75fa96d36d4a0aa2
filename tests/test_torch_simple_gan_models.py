'''The simple-GAN models of the port (TransGAN, HiT, ConvNeXt, VAN) against
`animeface_tpu/implementations/{TransGAN,HiT,ConvNeXt,VAN}/model.py`, each
G and D through its converter, and TransGAN's dropout.

Small widths (a few blocks, 8-64 channels, 16-32px, batch 4), f32 on the
CPU, one intra-op thread. Variables in flax's tree (from `jax.eval_shape`)
drawn from a seeded numpy stream with every parameter off its init value
(`draw_vars`: the zero-initialised gamma, layer scales and position
embeddings would hide their branches), bridged with `convert.py`. Inputs
are made from seeds with numpy. Each output agrees with JAX's at 1e-5 of
its scale (f32 through the same layers in two frameworks).

Dropout (TransGAN, 0.1 by default in G and D): flax's masks are captured
from the JAX forward (`nn.intercept_methods` on every `nn.Dropout`, the
mask read from which elements it zeroed) and replayed by the port's
dropout source, so the port's dropout sits where flax's does (after the
softmax, after the projection, after the MLP) and scales what it keeps by
1 / (1 - p): the outputs agree at 1e-5. The port's own masks keep 0.9 of
the elements within 3 standard deviations; the training step draws them
and the sampler does not.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from flax import linen as fnn

from animeface_tpu.implementations.ConvNeXt import model as jcm
from animeface_tpu.implementations.HiT import model as jhm
from animeface_tpu.implementations.SRGAN.model import pixel_shuffle as j_pixel_shuffle
from animeface_tpu.implementations.TransGAN import model as jtm
from animeface_tpu.implementations.VAN import model as jvm
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.ConvNeXt import model as tcm
from animeface_tpu_torch.implementations.HiT import model as thm
from animeface_tpu_torch.implementations.TransGAN import model as ttm
from animeface_tpu_torch.implementations.VAN import model as tvm
from animeface_tpu_torch.nnutils.module.linen import dropout
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)

RTOL = 1e-5
B, Z = 4, 8


def draw_vars(module, *inputs, seed=0):
    '''Parameters of `module` in flax's tree drawn from a seeded numpy
    stream: kernels N(0, 1 / fan_in), biases N(0, 0.1), norm scales U(0.5,
    1.5), every other parameter (position embeddings, cls token, HiT's
    q/k/v/o, gamma, layer scales) N(0, 1 / its last axis) or, if scalar,
    U(0.3, 0.6).'''
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs))['params']

    def draw(path, leaf):
        key, shape = str(path[-1].key), leaf.shape
        if key == 'kernel':
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key == 'bias':
            a = rng.standard_normal(shape) * 0.1
        elif key == 'scale':
            a = rng.uniform(0.5, 1.5, shape)
        elif shape == ():
            a = rng.uniform(0.3, 0.6, shape)
        else:
            a = rng.standard_normal(shape) / np.sqrt(shape[-1])
        return np.asarray(a, np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def nchw(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _z(seed=1):
    return np.random.default_rng(seed).standard_normal((B, Z)).astype(np.float32)


def _images(size, seed=2):
    return np.random.default_rng(seed).uniform(-1, 1, (B, size, size, 3)).astype(np.float32)


def check_g(jG, tG, params, state, rtol=RTOL):
    z = _z()
    want = jax.jit(jG.apply)({'params': params}, jnp.asarray(z))
    tG.load_state_dict(state)
    close(nhwc(tG(torch.from_numpy(z))), want, rtol, what='G')


def check_d(jD, tD, params, state, size, rtol=RTOL):
    x = _images(size)
    want = jax.jit(jD.apply)({'params': params}, jnp.asarray(x))
    tD.load_state_dict(state)
    close(tD(nchw(x)).detach().numpy(), want, rtol, what='D')


# ---------------------------------------------------------------- TransGAN

TG = dict(depths=(2, 1), latent_dim=Z, bottom_width=8, embed_dim=32, num_heads=4)
TD = dict(depth=2, image_size=16, patch_size=4, embed_dim=16, num_heads=4)


def test_token_shuffles_match_jax():
    '''TransGAN's token upsample is torch's PixelShuffle order (c, r, r),
    HiT's reads the channels as (2, 2, C / 4); each against its JAX twin.'''
    x = np.random.default_rng(0).standard_normal((2, 16, 8)).astype(np.float32)
    close(ttm.token_upsample(torch.from_numpy(x)).numpy(), jtm.token_upsample(jnp.asarray(x)),
          0, what='token_upsample')
    close(thm.token_pixel_shuffle(torch.from_numpy(x)).numpy(),
          jhm.token_pixel_shuffle(jnp.asarray(x)), 0, what='token_pixel_shuffle')
    grid = torch.from_numpy(x).reshape(2, 4, 4, 8)
    close(ttm.pixel_shuffle(grid, 2).numpy(), j_pixel_shuffle(jnp.asarray(grid.numpy()), 2), 0,
          what='pixel_shuffle')
    assert not np.array_equal(ttm.token_upsample(torch.from_numpy(x)).numpy(),
                              thm.token_pixel_shuffle(torch.from_numpy(x)).numpy())
    blocks = thm.block_tokens(torch.from_numpy(x), 2)
    close(blocks.numpy(), jhm.block_tokens(jnp.asarray(x), 2), 0, what='block_tokens')
    close(thm.unblock_tokens(blocks).numpy(), x, 0, what='unblock_tokens')


def test_transgan_generator_matches_jax():
    jG = jtm.Generator(**TG)
    p = draw_vars(jG, jnp.zeros((1, Z)))
    check_g(jG, ttm.Generator(**TG), p, convert.convert_transgan_generator(p, TG['depths']))


def test_transgan_discriminator_matches_jax():
    jD = jtm.Discriminator(**TD, qkv_bias=True)
    p = draw_vars(jD, jnp.zeros((1, 16, 16, 3)), seed=1)
    check_d(jD, ttm.Discriminator(**TD, qkv_bias=True), p,
            convert.convert_transgan_discriminator(p), 16)


def apply_recording_masks(module, params, x, key):
    '''`module` with a 'dropout' rng, jitted: (output, the masks of its
    Dropout layers in call order, read from which elements each zeroed).'''
    def run(params, x):
        masks = []

        def record(next_fun, args, kwargs, context):
            out = next_fun(*args, **kwargs)
            if isinstance(context.module, fnn.Dropout) and context.module.rate > 0:
                masks.append(out != 0)
            return out
        with fnn.intercept_methods(record):
            out = module.apply({'params': params}, x, rngs={'dropout': key})
        return out, masks
    out, masks = jax.jit(run)(params, jnp.asarray(x))
    return out, [np.asarray(m) for m in masks]


def replay(masks):
    '''A port dropout source that hands out `masks` in order, checking each
    call's shape and keep fraction.'''
    it = iter(masks)

    def source(shape, keep):
        m = next(it)
        assert m.shape == shape and keep == 0.9, (m.shape, shape, keep)
        return torch.from_numpy(np.array(m))
    return source


@pytest.mark.parametrize('part', ['G', 'D'])
def test_transgan_dropout_matches_flax(part):
    '''Dropout 0.1 on the attention probabilities, after the projection and
    after the MLP: the port replaying flax's masks gives flax's output.'''
    kw = dict(dropout=0.1, attn_dropout=0.1)
    if part == 'G':
        jm, tm, x = jtm.Generator(**TG, **kw), ttm.Generator(**TG, **kw), _z()
        p = draw_vars(jm, jnp.zeros((1, Z)))
        state, tx = convert.convert_transgan_generator(p, TG['depths']), torch.from_numpy(x)
    else:
        jm, tm, x = jtm.Discriminator(**TD, **kw), ttm.Discriminator(**TD, **kw), _images(16)
        p = draw_vars(jm, jnp.zeros((1, 16, 16, 3)), seed=1)
        state, tx = convert.convert_transgan_discriminator(p), nchw(x)
    want, masks = apply_recording_masks(jm, p, x, jax.random.PRNGKey(3))
    blocks = sum(TG['depths']) if part == 'G' else TD['depth']
    assert len(masks) == 3 * blocks
    tm.load_state_dict(state)
    got = tm(tx, dropout=replay(masks))
    got = nhwc(got) if part == 'G' else got.detach().numpy()
    close(got, want, RTOL, what=f'{part} with dropout')
    deterministic = tm(tx)
    assert not np.allclose(got, nhwc(deterministic) if part == 'G'
                           else deterministic.detach().numpy())


def test_dropout_keeps_and_scales():
    '''The port's own masks: keep fraction 0.9 within 3 standard deviations,
    the kept elements scaled by 1 / 0.9, no source or rate 0 the identity.'''
    x = torch.ones(200_000)
    y = dropout(x, 0.1, torch.Generator().manual_seed(0))
    kept = y != 0
    n = x.numel()
    assert abs(float(kept.float().mean()) - 0.9) <= 3 * np.sqrt(0.09 / n)
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.9))
    assert dropout(x, 0.1, None) is x and dropout(x, 0.0, torch.Generator()) is x
    z = dropout(x, 0.1, torch.Generator().manual_seed(0))
    assert torch.equal(y, z)                      # one seed, one mask


# ---------------------------------------------------------------- HiT

HG = dict(latent_dim=Z, dims=(32, 32, 16), bottom=8, low_stages=2, num_heads=(4, 4, 2),
          num_blocks=(1, 2, 1), patch_sizes=(4, 8))


def test_hit_generator_matches_jax():
    '''Two multi-axis-attention stages (8px, 16px) and a high-res stage at
    32px that emits RGB.'''
    jG = jhm.Generator(**HG)
    p = draw_vars(jG, jnp.zeros((1, Z)))
    check_g(jG, thm.Generator(**HG), p, convert.convert_hit_generator(p))


def test_hit_generator_two_rgb_stages_match_jax():
    '''Two high-res stages: the second adds its RGB to a nearest 2x
    upsample of the first's.'''
    cfg = dict(HG, low_stages=1, patch_sizes=(4,))
    jG = jhm.Generator(**cfg)
    p = draw_vars(jG, jnp.zeros((1, Z)), seed=3)
    check_g(jG, thm.Generator(**cfg), p, convert.convert_hit_generator(p))


def test_hit_discriminator_matches_jax():
    jD = jhm.Discriminator(image_size=32, channels=8, bottom=8)
    p = draw_vars(jD, jnp.zeros((2, 32, 32, 3)), seed=1)
    check_d(jD, thm.Discriminator(image_size=32, channels=8, bottom=8), p,
            convert.convert_hit_discriminator(p, 8), 32)


# ---------------------------------------------------------------- ConvNeXt

@pytest.mark.parametrize('block_type', sorted(jcm.BLOCKS))
def test_convnext_generator_matches_jax(block_type):
    '''Every entry of the BLOCKS ablation table ('bn': stateless batch
    statistics; 'ln': GroupNorm(1)).'''
    cfg = dict(latent_dim=Z, image_size=16, channels=8, block_type=block_type,
               blocks_per_scale=1)
    jG = jcm.Generator(**cfg)
    p = draw_vars(jG, jnp.zeros((1, Z)))
    check_g(jG, tcm.Generator(**cfg), p, convert.convert_convnext_generator(p, 1))


def test_convnext_discriminator_matches_jax():
    cfg = dict(depths=(1, 2, 1, 1), dims=(8, 16, 32, 64))
    jD = jcm.Discriminator(**cfg)
    p = draw_vars(jD, jnp.zeros((1, 32, 32, 3)), seed=1)
    check_d(jD, tcm.Discriminator(**cfg), p,
            convert.convert_convnext_discriminator(p, cfg['depths']), 32)


# ---------------------------------------------------------------- VAN

@pytest.mark.parametrize('norm_name', ['ln', 'gn', 'in'])
def test_van_generator_matches_jax(norm_name):
    cfg = dict(latent_dim=Z, image_size=16, channels=16, blocks_per_scale=1, norm_name=norm_name)
    jG = jvm.Generator(**cfg)
    p = draw_vars(jG, jnp.zeros((1, Z)))
    check_g(jG, tvm.Generator(**cfg), p, convert.convert_van_generator(p, 1))


def test_van_discriminator_matches_jax():
    cfg = dict(layers=(1, 2), channels=8)
    jD = jvm.Discriminator(**cfg)
    p = draw_vars(jD, jnp.zeros((1, 32, 32, 3)), seed=1)
    check_d(jD, tvm.Discriminator(**cfg), p, convert.convert_van_discriminator(p, cfg['layers']),
            32)


def test_converters_cover_every_parameter():
    '''Each converter fills every entry of the port's state dict (strict
    loads) and each JAX parameter lands once.'''
    cases = [
        (jtm.Generator(**TG), ttm.Generator(**TG), (jnp.zeros((1, Z)),),
         lambda p: convert.convert_transgan_generator(p, TG['depths'])),
        (jhm.Generator(**HG), thm.Generator(**HG), (jnp.zeros((1, Z)),),
         convert.convert_hit_generator),
        (jcm.Discriminator(), tcm.Discriminator(), (jnp.zeros((1, 32, 32, 3)),),
         lambda p: convert.convert_convnext_discriminator(p, (3, 3, 9, 3))),
        (jvm.Generator(image_size=16, channels=8), tvm.Generator(image_size=16, channels=8),
         (jnp.zeros((1, 128)),), lambda p: convert.convert_van_generator(p, 2)),
    ]
    for jm, tm, inputs, conv in cases:
        shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *inputs))['params']
        p = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
        state = conv(p)
        assert set(state) == set(tm.state_dict()), type(tm)
        assert sum(v.numel() for v in state.values()) == sum(
            np.size(a) for a in jax.tree_util.tree_leaves(p))
