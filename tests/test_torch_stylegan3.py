'''StyleGAN3 in the port against the JAX package: the ops it runs on
(bias_act, upfirdn2d at StyleGAN3's uses, conv2d_resample, filtered_lrelu in
its three memory modes), the filter design, and G and D through the
weight bridge.

Same seeded numpy inputs on both sides, NHWC in JAX and NCHW in the port,
f32 on the CPU. Tolerances: 1e-5 abs for single ops on unit-scale inputs
(the same taps summed in another order); 1e-4 relative to each tensor's
scale for G and D and their gradients (the two frameworks run the same f32
convolutions and matmuls in other orders through every layer, and the
demodulation's rsqrt and the sin of the Fourier input amplify last-bit
differences a little). The small model is `_sg3_args` of
tests/test_implementations.py: 32px, 4 layers, channels 8..32, style 32.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu import ops as jops
from animeface_tpu.implementations.StyleGAN3 import model as jm
from animeface_tpu.nnutils.loss import r1_regularizer as j_r1
from animeface_tpu_torch import ops as tops
from animeface_tpu_torch.convert import (
    convert_stylegan3_generator, convert_stylegan3_discriminator)
from animeface_tpu_torch.implementations.StyleGAN3 import model as tm
from animeface_tpu_torch.nnutils.loss import r1_regularizer

TOL = 1e-5
RTOL = 1e-4
GCFG = dict(image_size=32, latent_dim=32, num_layers=4, channels=8, max_channels=32,
            style_dim=32)
DCFG = dict(image_size=32, channels=8, max_channels=32)
B = 8


def _pair(shape, seed=0, scale=1.0):
    x = (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close(got, want, rtol=RTOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f'{what}: max abs err {err} vs scale {scale}'


# ---------------------------------------------------------------- ops

@pytest.mark.parametrize('act', sorted(jops.activation_funcs))
def test_bias_act_matches_jax(act):
    jx, tx = _pair((2, 5, 6, 4), seed=1)
    b = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    for kw in (dict(), dict(alpha=0.3, gain=0.7, clamp=0.9)):
        want = jops.bias_act(jx, jnp.asarray(b), act=act, **kw)
        got = tops.bias_act(tx, torch.from_numpy(b), act=act, **kw)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL, err_msg=str(kw))
    # 2-D input: the bias runs along the feature axis on both sides
    x2 = np.random.default_rng(3).standard_normal((3, 4)).astype(np.float32)
    np.testing.assert_allclose(
        tops.bias_act(torch.from_numpy(x2), torch.from_numpy(b), act=act).numpy(),
        np.asarray(jops.bias_act(jnp.asarray(x2), jnp.asarray(b), act=act)), atol=TOL)


def test_filter_design_matches_jax():
    for args in ((24, 8.0, 12.0, 64.0, False), (12, 8.0, 9.5, 32.0, True),
                 (12, 16.0, 4.0, 64.0, False)):
        np.testing.assert_allclose(tm.design_filter(*args).numpy(),
                                   np.asarray(jm.design_filter(*args)), atol=1e-7)
    assert tm.design_filter(1, 1.0, 1.0, 1.0) is None
    for size, layers in ((32, 4), (128, 14)):
        for t, j in zip(tm.get_layer_params(size, layers, 4096),
                        jm.get_layer_params(size, layers, 4096)):
            np.testing.assert_array_equal(t, j)
    assert tm.binomial_filter(4) == jm.binomial_filter(4) == [1, 3, 3, 1]


def _radial(taps=12):
    return np.array(jm.design_filter(taps, 8.0, 9.5, 32.0, radial=True))


def _sep(taps=24):
    return np.array(jm.design_filter(taps, 8.0, 12.0, 64.0))


@pytest.mark.parametrize('case', ['up4_24taps', 'radial_down', 'asym_gain'])
def test_upfirdn2d_stylegan3_uses_match_jax(case):
    '''up=4 with a 24-tap separable filter, a 12x12 radial 2-D down filter,
    and asymmetric padding lists with a gain; forward and input gradient.'''
    jx, tx = _pair((2, 9, 10, 3), seed=4)
    f, kw = {
        'up4_24taps': (_sep(24), dict(up=4, padding=[13, 10, 12, 11], gain=16.0)),
        'radial_down': (_radial(12), dict(down=2, padding=[5, 6, 6, 5])),
        'asym_gain': (_sep(12), dict(up=2, down=2, padding=[-1, 7, 3, -2], gain=4.0)),
    }[case]
    jf, tf = jnp.asarray(f), torch.from_numpy(f)
    want = jops.upfirdn2d(jx, jf, **kw)
    gw = np.random.default_rng(5).standard_normal(want.shape).astype(np.float32)
    wgrad = jax.grad(lambda v: jnp.sum(jops.upfirdn2d(v, jf, **kw) * gw))(jx)
    x = tx.clone().requires_grad_(True)
    got = tops.upfirdn2d(x, tf, **kw)
    (ggrad,) = torch.autograd.grad(got, x, torch.from_numpy(gw.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(_nhwc(ggrad), np.asarray(wgrad), atol=TOL)


@pytest.mark.parametrize('k,use_f', [(3, True), (1, True), (3, False)])
def test_conv2d_resample_down2_matches_jax(k, use_f):
    '''D's ConvAct: down=2 with the 4-tap binomial 2-D filter (padding k//2),
    and the plain same-size conv.'''
    jx, tx = _pair((2, 12, 12, 5), seed=6)
    w = np.random.default_rng(7).standard_normal((k, k, 5, 4)).astype(np.float32)
    fil = np.outer([1, 3, 3, 1], [1, 3, 3, 1]).astype(np.float32)
    f = fil / fil.sum() if use_f else None
    down = 2 if use_f else 1
    jf = None if f is None else jnp.asarray(f)
    tf = None if f is None else torch.from_numpy(f)

    def jfn(v, wk):
        return jops.conv2d_resample(v, wk, jf, down=down, padding=k // 2)

    want = jfn(jx, jnp.asarray(w))
    g = np.random.default_rng(8).standard_normal(want.shape).astype(np.float32)
    wgx, wgw = jax.grad(lambda v, wk: jnp.sum(jfn(v, wk) * g), argnums=(0, 1))(
        jx, jnp.asarray(w))
    x = tx.clone().requires_grad_(True)
    tw = torch.from_numpy(w.transpose(3, 2, 0, 1).copy()).requires_grad_(True)
    got = tops.conv2d_resample(x, tw, tf, down=down, padding=k // 2)
    gx, gw = torch.autograd.grad(got, (x, tw), torch.from_numpy(g.transpose(0, 3, 1, 2).copy()))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL)
    np.testing.assert_allclose(_nhwc(gx), np.asarray(wgx), atol=TOL)
    np.testing.assert_allclose(gw.numpy().transpose(2, 3, 1, 0), np.asarray(wgw), atol=1e-4)


FLRELU = {
    # a same-rate layer: 12-tap up filter, 12x12 radial down filter
    'up2_radial': (lambda: (_sep(12), _radial(12)), (2, 9, 9, 4),
                   dict(up=2, down=2, padding=[11, 10, 11, 10], clamp=1.5)),
    # a rate-doubling layer: up=4 with 24 taps
    'up4': (lambda: (_sep(24), _radial(12)), (2, 7, 7, 3),
            dict(up=4, down=2, padding=[21, 20, 21, 20], clamp=None)),
    # the RGB layer: no filters, slope 1, gain 1, clamp
    'rgb': (lambda: (None, None), (2, 6, 6, 3),
            dict(up=1, down=1, padding=0, gain=1.0, slope=1.0, clamp=0.8)),
}


@pytest.mark.parametrize('memory', ['store', 'pack', 'remat'])
@pytest.mark.parametrize('case', sorted(FLRELU))
def test_filtered_lrelu_matches_jax(case, memory):
    '''Each memory mode against the JAX store path: forward, and the input
    and bias gradients of a cubic loss (the clamp and both slopes active).'''
    filters, shape, kw = FLRELU[case]
    fu, fd = filters()
    jx, tx = _pair(shape, seed=9, scale=2.0)
    b = np.random.default_rng(10).standard_normal(shape[-1]).astype(np.float32) * 0.3
    jfu, jfd = [None if f is None else jnp.asarray(f) for f in (fu, fd)]
    tfu, tfd = [None if f is None else torch.from_numpy(f) for f in (fu, fd)]

    def jfn(v, bb):
        return jops.filtered_lrelu(v, jfu, jfd, bb, memory='store', **kw)

    want = jfn(jx, jnp.asarray(b))
    wgx, wgb = jax.grad(lambda v, bb: jnp.sum(jfn(v, bb) ** 3), argnums=(0, 1))(
        jx, jnp.asarray(b))
    x = tx.clone().requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = tops.filtered_lrelu(x, tfu, tfd, tb, memory=memory, **kw)
    gx, gb = torch.autograd.grad((got ** 3).sum(), (x, tb))
    np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=TOL)
    _close(_nhwc(gx), wgx, rtol=1e-5, what='dx')
    _close(gb.numpy(), wgb, rtol=1e-5, what='db')


def test_gate_code_packing_round_trips():
    from animeface_tpu_torch.ops.filtered_lrelu import pack_codes, unpack_codes
    codes = torch.from_numpy(np.random.default_rng(11).integers(0, 3, (2, 3, 5, 7))
                             .astype(np.uint8))
    packed = pack_codes(codes)
    assert packed.dtype == torch.uint8 and packed.numel() == -(-codes.numel() // 4)
    assert torch.equal(unpack_codes(packed, codes.shape), codes)


# ---------------------------------------------------------------- G and D

def _randomize_biases(tree, rng):
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1
                         if path[-1].key == 'bias' else np.asarray(a)), tree)


@pytest.fixture(scope='module')
def gen():
    jG = jm.Generator(**GCFG)
    gv = jax.device_get(jax.jit(jG.init)({'params': jax.random.PRNGKey(0)},
                                         jnp.zeros((1, 32))))
    gp = _randomize_biases(gv['params'], np.random.default_rng(0))
    moments = jax.tree_util.tree_map(np.asarray, gv['moments'])
    moments['map']['w_avg'] = np.random.default_rng(1).standard_normal(32).astype(np.float32)
    tG = tm.Generator(**GCFG)
    tG.load_state_dict(convert_stylegan3_generator(gp, moments))
    return jG, gp, moments, tG


def test_generator_layers_match_jax_shapes(gen):
    jG, gp, moments, tG = gen
    assert len(tG.synthesis.net) == 5
    assert [tuple(layer.padding) for layer in tG.synthesis.net][-1] == (0, 0, 0, 0)
    assert tG.synthesis.net[0].down_filter.ndim == 2          # radial
    assert tG.synthesis.net[3].down_filter.ndim == 1          # critically sampled
    assert tG.synthesis.net[1].up_factor == 4


@pytest.mark.parametrize('train', [False, True])
def test_generator_matches_jax(gen, train):
    '''Forward, the updated moments (train=True), and the gradients of every
    parameter and of z.'''
    jG, gp, moments, tG = gen
    z = np.random.default_rng(12).standard_normal((B, 32)).astype(np.float32)
    g = np.random.default_rng(13).standard_normal((B, 32, 32, 3)).astype(np.float32)

    def jfn(params, zz):
        out, mut = jG.apply({'params': params, 'moments': moments}, zz, train=train,
                            mutable=['moments'])
        return jnp.sum(out * g), (out, mut['moments'])

    (_, (want, new_m)), (wgp, wgz) = jax.jit(jax.value_and_grad(
        jfn, argnums=(0, 1), has_aux=True))(gp, jnp.asarray(z))

    tG.load_state_dict(convert_stylegan3_generator(gp, moments))
    tG.zero_grad(set_to_none=True)
    tz = torch.from_numpy(z).requires_grad_(True)
    out = tG(tz, train=train)
    (out * torch.from_numpy(g.transpose(0, 3, 1, 2).copy())).sum().backward()
    _close(_nhwc(out), want, what='G(z)')
    _close(tz.grad.numpy(), wgz, what='dz')
    want_grads = convert_stylegan3_generator(wgp, moments)
    for name, p in tG.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), what=f'grad {name}')
    want_m = convert_stylegan3_generator(gp, jax.device_get(new_m))
    for name, buf in tG.state_dict().items():
        if 'magnitude_ema' in name or 'w_avg' in name:
            _close(buf.numpy(), want_m[name].numpy(), rtol=1e-5, what=name)


@pytest.fixture(scope='module')
def disc():
    jD = jm.Discriminator(**DCFG)
    dp = jax.device_get(jax.jit(jD.init)(jax.random.PRNGKey(1),
                                         jnp.zeros((2, 32, 32, 3)))['params'])
    dp = _randomize_biases(dp, np.random.default_rng(2))
    tD = tm.Discriminator(**DCFG)
    tD.load_state_dict(convert_stylegan3_discriminator(dp))
    return jD, dp, tD


def test_discriminator_matches_jax(disc):
    '''Logits, parameter and input gradients; batch 8 runs two strided
    minibatch-stddev groups of 4.'''
    jD, dp, tD = disc
    jx, tx = _pair((B, 32, 32, 3), seed=14)
    w = np.random.default_rng(15).standard_normal((B, 1)).astype(np.float32)

    def jfn(params, v):
        return jnp.sum(jD.apply({'params': params}, v) * w)

    want = jD.apply({'params': dp}, jx)
    wgp, wgx = jax.jit(jax.grad(jfn, argnums=(0, 1)))(dp, jx)
    tD.zero_grad(set_to_none=True)
    x = tx.clone().requires_grad_(True)
    logits = tD(x)
    (logits * torch.from_numpy(w)).sum().backward()
    _close(logits.detach().numpy(), want, what='D(x)')
    _close(_nhwc(x.grad), wgx, what='dx')
    want_grads = convert_stylegan3_discriminator(wgp)
    for name, p in tD.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), what=f'grad {name}')


def test_discriminator_r1_matches_jax(disc):
    '''The additive R1 term and its parameter gradients (a double backward
    through D).'''
    jD, dp, tD = disc
    jx, tx = _pair((B, 32, 32, 3), seed=16)
    fn = jax.jit(jax.value_and_grad(
        lambda params: j_r1(jx, lambda im: jD.apply({'params': params}, im))))
    want, wgp = fn(dp)
    tD.zero_grad(set_to_none=True)
    r1 = r1_regularizer(tx, tD)
    r1.backward()
    _close(float(r1.detach()), float(want), what='r1')
    want_grads = convert_stylegan3_discriminator(wgp)
    for name, p in tD.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad   # out of R1's graph
        _close(got.numpy(), want_grads[name].numpy(), what=f'grad {name}')
