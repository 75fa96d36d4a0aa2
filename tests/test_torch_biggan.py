'''BigGAN's modules in the port against `animeface_tpu/implementations/BigGAN/
model.py`: `_arch` at 32-512px, deep and not; each module (conditional norm
'bn' and 'in' with spectral norm on and off, the four blocks with relu,
lrelu and prelu, SAGAN attention, SE, the lambda layer), each in train
and eval mode, with the spectral norms' u and the running statistics it
leaves; `get_activation` against the JAX table. G and D are in
`tests/test_torch_biggan_{nets,deep}.py`, the steps in
`tests/test_torch_biggan_steps.py` and `tests/test_torch_sebiggan_step.py`.

Small widths (channels 4, z 16, 32px, batch 4), f32 on the CPU, one
intra-op thread. Variables in flax's tree drawn from a seeded numpy stream
(`init_vars`: flax's jitted `init` of a whole G costs seconds of compile
each), with every running mean and variance, norm scale and bias,
attention's gamma (0 at init, which would hide the attention path) and
PReLU's slope off its init value, bridged with
`convert_biggan_generator`/`convert_biggan_discriminator` (a module alone
with `_convert_module`). Tolerance: 1e-5 of the output's scale for a module,
1e-4 for G and D (the same f32 convolutions summed in another order).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.BigGAN import model as jm
from animeface_tpu.nnutils.module import get_activation as j_get_activation
from animeface_tpu_torch import convert
from animeface_tpu_torch.implementations.BigGAN import model as tm
from animeface_tpu_torch.nnutils.module import get_activation
from test_torch_pggan import close, one_thread  # noqa: F401  (autouse fixture)

MOD_RTOL, NET_RTOL = 1e-5, 1e-4
B, Z, CH, S = 4, 16, 4, 32


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def init_vars(module, *inputs, seed=0):
    '''Variables of `module` with flax's tree (from `jax.eval_shape`, no
    compile) drawn from a seeded numpy stream: kernels N(0, 1 / fan_in),
    biases N(0, 0.01), u N(0, 1), running means N(0, 0.04), variances and
    norm scales U(0.5, 1.5), gamma U(0.3, 0.6), PReLU slopes U(0.1, 0.3),
    pos_emb N(0, 1): every statistic, scale and gain off its init value.'''
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, train=True))

    def draw(path, leaf):
        key, shape = str(getattr(path[-1], 'key', path[-1])), leaf.shape
        if key.endswith('kernel'):
            a = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith('/u') or key == 'pos_emb':
            a = rng.standard_normal(shape)
        elif key == 'bias':
            a = rng.standard_normal(shape) * 0.1
        elif key == 'mean':
            a = rng.standard_normal(shape) * 0.2
        elif key in ('var', 'scale'):
            a = rng.uniform(0.5, 1.5, shape)
        elif key == 'gamma':
            a = rng.uniform(0.3, 0.6, shape)
        elif key == 'negative_slope':
            a = rng.uniform(0.1, 0.3, shape)
        elif key.endswith('sigma'):
            a = np.ones(shape)
        else:
            raise KeyError(path)
        return a.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def run_jax(module, v, *inputs, train):
    '''(output, variables after the call) of a flax module.'''
    if train:
        y, mut = module.apply(v, *inputs, train=True, mutable=['batch_stats'])
        return np.asarray(y), dict(v, **jax.device_get(mut))
    return np.asarray(module.apply(v, *inputs, train=False)), v


def check_state(module, want, rtol, what=''):
    '''Every entry of the port's state_dict (parameters, u, running
    statistics) against a converted JAX state.'''
    got = module.state_dict()
    assert set(got) == set(want), (sorted(set(got) ^ set(want)), what)
    for name, v in got.items():
        close(v.numpy(), want[name].numpy(), rtol=rtol, what=f'{what} {name}')


def _convert_module(kind, variables):
    '''The port state of one block, conditional norm or attention module
    from its flax variables, through the model converters' own helpers.'''
    p, s = variables['params'], variables.get('batch_stats', {})
    out = {}
    if kind == 'ConditionalNorm':
        convert._biggan_cn(p, s, 'm', out)
    elif kind in convert._BIGGAN_ATTENTION:
        convert._biggan_attention(kind, p, s, 'm', out)
    else:
        convert._biggan_block(kind, p, s, 'm', out)
    return {k[2:]: v for k, v in out.items()}


@pytest.mark.parametrize('deep', [False, True], ids=['normal', 'deep'])
@pytest.mark.parametrize('size', [32, 64, 128, 256, 512])
def test_arch_matches_jax(size, deep):
    assert tm._arch(size, deep) == jm._arch(size, deep)


@pytest.mark.parametrize('name', ['relu', 'lrelu', 'leakyrelu', 'tanh', 'gelu', 'swish', 'silu',
                                  'sigmoid'])
def test_get_activation_matches_jax(name):
    x = np.random.default_rng(0).standard_normal(64).astype(np.float32) * 3
    x[:4] = 0
    want = np.asarray(j_get_activation(name)(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda v: j_get_activation(name)(v).sum())(jnp.asarray(x)))
    t = torch.from_numpy(x).requires_grad_(True)
    y = get_activation(name)(t)
    y.sum().backward()
    close(y.detach().numpy(), want, rtol=MOD_RTOL, what=name)
    close(t.grad.numpy(), want_grad, rtol=MOD_RTOL, what=f'{name} grad')


def test_prelu_matches_flax():
    act = get_activation('prelu')
    assert float(act.negative_slope) == pytest.approx(0.01)
    jp = jax.device_get(jm.nn.PReLU().init(jax.random.PRNGKey(0), jnp.zeros(3)))
    assert float(jp['params']['negative_slope']) == pytest.approx(0.01)
    x = np.linspace(-2, 2, 9, dtype=np.float32)
    close(act(torch.from_numpy(x)).detach().numpy(),
          jm.nn.PReLU().apply(jp, jnp.asarray(x)), rtol=1e-7, what='prelu')


#: (kind, JAX module, port module, NHWC input shape, takes z)
MODULES = {
    'cn-bn': ('ConditionalNorm', lambda: jm.ConditionalNorm(norm_name='bn'),
              lambda: tm.ConditionalNorm(8, Z, norm_name='bn'), (B, 8, 8, 8), True),
    'cn-in-nosn': ('ConditionalNorm', lambda: jm.ConditionalNorm(False, norm_name='in'),
                   lambda: tm.ConditionalNorm(8, Z, False, norm_name='in'), (B, 8, 8, 8), True),
    'gblock-up': ('GBlock', lambda: jm.GBlock(8, True),
                  lambda: tm.GBlock(16, 8, Z, True), (B, 8, 8, 16), True),
    'gblock-flat-prelu': ('GBlock', lambda: jm.GBlock(16, False, act_name='prelu'),
                          lambda: tm.GBlock(16, 16, Z, False, act_name='prelu'),
                          (B, 8, 8, 16), True),
    'gblockdeep-up': ('GBlockDeep', lambda: jm.GBlockDeep(8, True),
                      lambda: tm.GBlockDeep(16, 8, Z, True), (B, 8, 8, 16), True),
    'gblockdeep-flat-in': ('GBlockDeep', lambda: jm.GBlockDeep(16, False, norm_name='in'),
                           lambda: tm.GBlockDeep(16, 16, Z, False, norm_name='in'),
                           (B, 8, 8, 16), True),
    'dblock-down': ('DBlock', lambda: jm.DBlock(16, True),
                    lambda: tm.DBlock(8, 16, True), (B, 8, 8, 8), False),
    'dblock-flat-lrelu': ('DBlock', lambda: jm.DBlock(8, False, act_name='lrelu'),
                          lambda: tm.DBlock(8, 8, False, act_name='lrelu'), (B, 8, 8, 8), False),
    'dblockdeep-down': ('DBlockDeep', lambda: jm.DBlockDeep(16, True),
                        lambda: tm.DBlockDeep(8, 16, True), (B, 8, 8, 8), False),
    'dblockdeep-flat-nosn': ('DBlockDeep', lambda: jm.DBlockDeep(16, False, False),
                             lambda: tm.DBlockDeep(16, 16, False, False), (B, 8, 8, 16), False),
    'sa': ('SelfAttention', lambda: jm.SelfAttention(),
           lambda: tm.SelfAttention(16), (B, 8, 8, 16), False),
    'se': ('SqueezeExcitation', lambda: jm.SqueezeExcitation(),
           lambda: tm.SqueezeExcitation(32), (B, 4, 4, 32), False),
    'll': ('LambdaLayer', lambda: jm.LambdaLayer(),
           lambda: tm.LambdaLayer(16, 4), (B, 4, 4, 16), False),
}


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('name', list(MODULES))
def test_module_matches_jax(name, train):
    kind, make_j, make_t, shape, takes_z = MODULES[name]
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal((B, Z)).astype(np.float32)
    jmod = make_j()
    inputs = (jnp.asarray(x), jnp.asarray(z)) if takes_z else (jnp.asarray(x),)
    v = init_vars(jmod, *inputs)
    want, new_v = run_jax(jmod, v, *inputs, train=train)
    port = make_t()
    port.load_state_dict(_convert_module(kind, v))
    with torch.no_grad():
        got = port(_nchw(x), torch.from_numpy(z), train) if takes_z else port(_nchw(x), train)
    close(_nhwc(got), want, rtol=MOD_RTOL, what=name)
    check_state(port, _convert_module(kind, new_v), MOD_RTOL, what=f'{name} state')
    if kind == 'SelfAttention':
        assert abs(float(port.gamma)) > 0.1
