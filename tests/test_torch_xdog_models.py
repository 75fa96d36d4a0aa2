'''The rest of the xdog recipes' models against the JAX package's, in f32
on the CPU: `ops.grid_sample` and SCFT's TPS warp, normalizations'
`Normalization` of each kind and its G, SPADE's G and encoder, SCFT's G
(with its q and k) and D, each through its converter.

`grid_sample` agrees within 1e-5 (absolute, images in [-1, 1]), on a
TPS grid that reaches past [-1, 1] and on a random one. The TPS grid from
JAX's offsets (the draws of its key, injected here) agrees within
cond(A) * 2^-23 of the grid's scale: JAX solves A (cond 141.3 for the 4x4
control points) in float32, the port once in float64. Every other output
within 1e-5 of its scale (normalizations' G with 'bn' within 3e-5: JAX's
f32 rounding of BatchNorm at batch 2 alone is 1e-5 of it); the models run
`train=True` (BatchNorm's batch
statistics, one power iteration of every spectral norm), and the state
they leave (running statistics, u) is held too.

Variables come from `xdog_vars`: flax's tree from `jax.eval_shape` drawn
with numpy, every parameter, u and statistic off its init value.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.SCFT import model as jc
from animeface_tpu.implementations.SCFT import tps as jtps
from animeface_tpu.implementations.SPADE import model as js
from animeface_tpu.implementations.normalizations import model as jn
from animeface_tpu.ops import grid_sample as jgrid_sample
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.SCFT import model as tc
from animeface_tpu_torch.implementations.SCFT import tps as ttps
from animeface_tpu_torch.implementations.SPADE import model as ts
from animeface_tpu_torch.implementations.normalizations import model as tn
from animeface_tpu_torch.ops import grid_sample
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)
from test_torch_simple_gan_models import nchw, nhwc
from test_torch_simple_gan_steps import FAST_COMPILE

RTOL = 1e-5


def xdog_vars(module, *inputs, seed=0, **kw):
    '''Variables of `module` with flax's tree (from `jax.eval_shape`, no
    compile) drawn from a seeded numpy stream: kernels N(0, 1 / fan_in),
    biases N(0, 0.1), u N(0, 1), running means N(0, 0.04), variances and
    norm scales U(0.5, 1.5), normalizations' gamma U(0.5, 1.5), beta
    N(0, 0.1), affine_bias 1 or 0 + N(0, 0.1), rho U(0.2, 0.8); sigma 1.'''
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kw))

    def draw(path, leaf):
        key, shape = str(getattr(path[-1], 'key', path[-1])), leaf.shape
        if key.endswith('kernel'):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith('/u'):
            a = rng.standard_normal(shape)
        elif key in ('bias', 'beta'):
            a = rng.standard_normal(shape) * 0.1
        elif key == 'mean':
            a = rng.standard_normal(shape) * 0.2
        elif key in ('var', 'scale', 'gamma'):
            a = rng.uniform(0.5, 1.5, shape)
        elif key == 'affine_bias':
            c = shape[0] // 2
            a = np.concatenate([np.ones(c), np.zeros(c)]) + rng.standard_normal(shape) * 0.1
        elif key == 'rho':
            a = rng.uniform(0.2, 0.8, shape)
        elif key.endswith('sigma'):
            a = np.ones(shape)
        else:
            raise KeyError(path)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def near(got, want, atol, what):
    err = float(np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64)).max())
    assert err <= atol, f'{what}: max abs err {err} vs {atol}'


def _inputs(shape, seed, low=-1.0, high=1.0):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(np.float32)


def _japply(module, variables, *args, **kw):
    '''`module.apply` with the batch statistics mutable, jitted fast; (out,
    new batch_stats).'''
    def f(v, *a):
        return module.apply(v, *a, mutable=['batch_stats'], **kw)
    out, mut = jax.jit(f).lower(variables, *args).compile(FAST_COMPILE)(variables, *args)
    return out, {'params': variables['params'], **mut}


KEY = jax.random.PRNGKey(3)
B, SIZE = 2, 24


def _tps(key=KEY, size=SIZE):
    '''JAX's grid for `key` (jitted fast) and the offsets its key draws,
    as the port takes them.'''
    n = ttps.GRID_POINTS ** 2
    offsets = np.array(jax.random.normal(key, (B, n, 2)) * ttps.STD)
    grid = jax.jit(lambda k: jtps.tps_grid(k, B, size, size)).lower(key).compile(FAST_COMPILE)
    return np.asarray(grid(key)), torch.from_numpy(offsets)


def test_tps_grid_matches_jax():
    _, A = ttps.tps_system()
    cond = float(np.linalg.cond(A))
    assert cond == pytest.approx(141.3, abs=0.05)
    want, offsets = _tps()
    got = ttps.TPSWarp(SIZE, SIZE).grid(offsets)
    tol = cond * 2.0 ** -23 * float(np.abs(want).max())
    assert float(np.abs(want).max()) > 1                      # the warp leaves [-1, 1]
    near(got.numpy(), want, tol, 'tps_grid')
    # the grid is linear in the offsets: no offsets, the pixel centres
    flat = ttps.TPSWarp(SIZE, SIZE).grid(torch.zeros_like(offsets))
    lin = np.linspace(-1, 1, SIZE)
    assert np.allclose(flat[0, ..., 0].numpy(), lin[None, :], atol=1e-6)
    assert np.allclose(flat[0, ..., 1].numpy(), lin[:, None], atol=1e-6)


@pytest.mark.parametrize('grid', ['tps', 'random'])
def test_grid_sample_matches_jax(grid):
    x = _inputs((B, SIZE, SIZE, 3), 1)
    g = _tps()[0] if grid == 'tps' else _inputs((B, 17, 19, 2), 2, -1.2, 1.2)
    near(nhwc(grid_sample(nchw(x), torch.from_numpy(g))), jgrid_sample(x, g), 1e-5,
         f'grid_sample on a {grid} grid')


def test_tps_transform_matches_jax():
    x = _inputs((B, SIZE, SIZE, 3), 3)
    _, offsets = _tps()
    got = ttps.TPSWarp(SIZE, SIZE)(nchw(x), offsets)
    want = jax.jit(jtps.tps_transform).lower(KEY, x).compile(FAST_COMPILE)(KEY, x)
    near(nhwc(got), want, 1e-5, 'tps_transform')


@pytest.mark.parametrize('kind', ['bn', 'in', 'ln', 'lin', 'lin clipped', 'polin'])
def test_normalization_matches_jax(kind):
    '''Each kind with its affine terms (BatchNorm's own), in train mode;
    LIN's rho read through its clip at 1.3.'''
    name = kind.split()[0]
    jm = jn.Normalization(name)
    x = _inputs((B, 5, 6, 8), 4) * 3 + 0.5
    variables = xdog_vars(jm, jnp.zeros((B, 5, 6, 8)), seed=5)
    if kind == 'lin clipped':
        variables = jax.tree_util.tree_map(lambda a: a, variables)
        variables['params']['rho'] = np.full((1,), 1.3, np.float32)
    want, new = _japply(jm, variables, x)
    m = tn.Normalization(name, 8)
    sd = {}
    convert._normalization(variables['params'], variables.get('batch_stats', {}), 'n', sd)
    m.load_state_dict({k[2:]: v for k, v in sd.items()})
    close(nhwc(m(nchw(x))), want, rtol=RTOL, what=f'Normalization {kind}')
    if name == 'bn':
        sd = {}
        convert._normalization(new['params'], new['batch_stats'], 'n', sd)
        for k, v in m.state_dict().items():
            close(v.numpy(), sd[f'n.{k}'].numpy(), rtol=RTOL, what=f'bn {k}')


@pytest.mark.parametrize('norm', ['in', 'bn', 'lin', 'polin'])
def test_normalizations_generator_matches_jax(norm):
    '''32px from a 16px bottom, two residual blocks; the style map
    flattened NHWC into its Dense on both sides.'''
    kw = dict(image_size=32, bottom=16, channels=4, max_channels=8, style_dim=8,
              num_blocks=2, norm_name=norm)
    jG = jn.Generator(**kw)
    content, style = _inputs((B, 32, 32, 1), 6), _inputs((B, 32, 32, 3), 7)
    variables = xdog_vars(jG, jnp.zeros((B, 32, 32, 1)), jnp.zeros((B, 32, 32, 3)), seed=8)
    want, new = _japply(jG, variables, content, style, train=True)
    G = tn.Generator(**kw)
    G.load_state_dict(convert.convert_normalizations_generator(variables))
    # with 'bn' (flax's E[x^2] - E[x]^2 over a batch of 2) JAX's own f32
    # rounding reaches 1e-5 of the scale: the float64 port lies 9.8e-6 from it
    rtol = 3e-5 if norm == 'bn' else RTOL
    close(nhwc(G(nchw(content), nchw(style))), want, rtol=rtol, what=f'normalizations G {norm}')
    for k, v in convert.convert_normalizations_generator(new).items():
        close(G.state_dict()[k].numpy(), v.numpy(), rtol=rtol, what=f'new {k}')


def test_spade_generator_matches_jax():
    '''16px, BatchNorm in the SPADE blocks, spectral norm on; the 1-channel
    segmentation map resized nearest to 4-8px; train=True, u and the
    running statistics after it held.'''
    kw = dict(image_size=16, z_dim=8, channels=2, max_channels=8, spade_hidden_channels=4)
    jG = js.Generator(**kw)
    z, seg = _inputs((B, 8), 9), _inputs((B, 16, 16, 1), 10)
    variables = xdog_vars(jG, jnp.zeros((B, 8)), jnp.zeros((B, 16, 16, 1)), seed=11)
    want, new = _japply(jG, variables, z, seg, train=True)
    G = ts.Generator(**kw)
    G.load_state_dict(convert.convert_spade_generator(variables))
    close(nhwc(G(torch.from_numpy(z), nchw(seg))), want, rtol=RTOL, what='SPADE G')
    for k, v in convert.convert_spade_generator(new).items():
        close(G.state_dict()[k].numpy(), v.numpy(), rtol=RTOL, what=f'new {k}')


def test_spade_encoder_matches_jax():
    '''16px to a 4px target with spectral norm on (the CLI's setting):
    (z, mu, logvar) with the noise of its key injected.'''
    kw = dict(image_size=16, z_dim=8, channels=2, use_sn=True)
    jE = js.Encoder(**kw)
    x = _inputs((B, 16, 16, 3), 12)
    variables = xdog_vars(jE, jnp.zeros((B, 16, 16, 3)), KEY, seed=13)
    (z, mu, logvar), new = _japply(jE, variables, x, KEY)
    eps = torch.from_numpy(np.asarray(jax.random.normal(KEY, (B, 8))))
    E = ts.Encoder(**kw)
    E.load_state_dict(convert.convert_spade_encoder(variables))
    got = E(nchw(x), eps)
    for g, w, name in zip(got, (z, mu, logvar), ('z', 'mu', 'logvar')):
        close(g.detach().numpy(), w, rtol=RTOL, what=f'SPADE E {name}')
    for k, v in convert.convert_spade_encoder(new).items():
        close(E.state_dict()[k].numpy(), v.numpy(), rtol=RTOL, what=f'new {k}')


def test_scft_generator_matches_jax():
    '''32px to an 8px bottom (the features 2 + 2 + 4 + 4 + 8 + 8 = 28
    channels), one residual block, spectral norm on: the image, q and k
    (float32), and every u after the call.'''
    kw = dict(image_size=32, bottom_width=8, enc_channels=2, num_res_blocks=1)
    jG = jc.Generator(**kw)
    sketch, ref = _inputs((B, 32, 32, 1), 14), _inputs((B, 32, 32, 3), 15)
    variables = xdog_vars(jG, jnp.zeros((B, 32, 32, 1)), jnp.zeros((B, 32, 32, 3)), seed=16)
    (want, (q, k)), new = _japply(jG, variables, sketch, ref, return_qk=True, train=True)
    G = tc.Generator(**kw)
    G.load_state_dict(convert.convert_scft_generator(variables))
    got, (gq, gk) = G(nchw(sketch), nchw(ref), return_qk=True)
    assert sum(G.sketch_encoder.feature_channels) == 28
    close(nhwc(got), want, rtol=RTOL, what='SCFT G')
    close(gq.detach().numpy(), q, rtol=RTOL, what='SCFT q')
    close(gk.detach().numpy(), k, rtol=RTOL, what='SCFT k')
    for name, v in convert.convert_scft_generator(new).items():
        close(G.state_dict()[name].numpy(), v.numpy(), rtol=RTOL, what=f'new {name}')


def test_scft_discriminator_matches_jax():
    '''The default D at 128px (VALID: 63, 30, 14, 6, then 3x3 logits) and
    its activations; at 64px the last conv's input is 2x2 and PyTorch
    raises (JAX's assert).'''
    jD = jc.Discriminator(channels=2)
    x = _inputs((B, 128, 128, 4), 17)
    variables = xdog_vars(jD, jnp.zeros((B, 128, 128, 4)), seed=18)
    (logits, feats), new = _japply(jD, variables, x)
    D = tc.Discriminator(channels=2)
    D.load_state_dict(convert.convert_scft_discriminator(variables))
    got, got_feats = D(nchw(x))
    assert got.shape == (B, 1, 3, 3)
    close(nhwc(got), logits, rtol=RTOL, what='SCFT D logits')
    for g, w in zip(got_feats, feats):
        close(nhwc(g), w, rtol=RTOL, what='SCFT D feature')
    for name, v in convert.convert_scft_discriminator(new).items():
        close(D.state_dict()[name].numpy(), v.numpy(), rtol=RTOL, what=f'new {name}')
    with pytest.raises(RuntimeError, match='Kernel size'):
        D(torch.zeros(1, 4, 64, 64))
