'''DiffAugment in the port against `animeface_tpu/nnutils/diffaugment.py`.

Both sides augment the same seeded numpy images (NHWC for JAX, NCHW for
the port) with the same draws: the port's are replayed from the JAX key by
`jax_draws`, which splits it as `diff_augment` does (`split(key, len(fns))`
in `AUGMENT_FNS` order, then `split(k)` into kh, kw for translation and
cutout). Sizes 16 (an even cutout, ch = 8) and 10 (an odd one, ch = 5).
Translation and cutout move or zero values, so they must agree bitwise,
values and gradients; the color functions take means, summed in another
order, so they agree within 1e-6 abs in f32.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.nnutils import diffaugment as jda
from animeface_tpu_torch.nnutils import diffaugment as tda

COLOR_ATOL = 1e-6
POLICIES = ['', 'color', 'translation', 'cutout', 'color,translation,cutout']
N, C = 6, 3


def jax_fn_draw(f, k, shape, dtype=jnp.float32):
    '''The draw JAX's function `f(k, x)` makes for x of NHWC `shape`, in
    the port's format.'''
    n, h, w, _ = shape
    if f is jda.rand_translation or f is jda.rand_cutout:
        if f is jda.rand_translation:
            sh, sw = int(h * 0.125 + 0.5), int(w * 0.125 + 0.5)
            lims = ((-sh, sh + 1), (-sw, sw + 1))
        else:
            ch, cw = int(h * 0.5 + 0.5), int(w * 0.5 + 0.5)
            lims = ((0, h + (1 - ch % 2)), (0, w + (1 - cw % 2)))
        return tuple(torch.from_numpy(np.array(jax.random.randint(kk, (n, 1, 1), lo, hi))
                                      .reshape(n).astype(np.int64))
                     for kk, (lo, hi) in zip(jax.random.split(k), lims))
    u = np.array(jax.random.uniform(k, (n, 1, 1, 1), dtype), np.float32)
    return torch.from_numpy(u).to(torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)


def jax_draws(key, shape, policy, dtype=jnp.float32):
    '''The draws JAX's `diff_augment(key, x, policy)` makes for x of NHWC
    `shape`, in the port's format.'''
    fns = [f for p in policy.split(',') for f in jda.AUGMENT_FNS[p]] if policy else []
    return [jax_fn_draw(f, k, shape, dtype)
            for k, f in zip(jax.random.split(key, len(fns)), fns)]


def _images(size, seed=0):
    return np.random.default_rng(seed).uniform(-1, 1, (N, size, size, C)).astype(np.float32)


def _nchw(a):
    return torch.from_numpy(np.array(np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _exact(policy):
    return 'color' not in policy


def _compare(got, want, exact, what):
    if exact:
        np.testing.assert_array_equal(got, np.asarray(want), err_msg=what)
    else:
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=COLOR_ATOL, err_msg=what)


@pytest.mark.parametrize('size', [16, 10])
@pytest.mark.parametrize('policy', POLICIES)
def test_diff_augment_and_gradient_match_jax(policy, size):
    x = _images(size)
    g = np.random.default_rng(1).standard_normal(x.shape).astype(np.float32)
    key = jax.random.PRNGKey(size)

    def jfn(xx):
        return jnp.sum(jda.diff_augment(key, xx, policy) * g)

    want = jda.diff_augment(key, jnp.asarray(x), policy)
    want_grad = jax.grad(jfn)(jnp.asarray(x))

    tx = _nchw(x).requires_grad_(True)
    got = tda.diff_augment(tx, policy, jax_draws(key, x.shape, policy))
    (got * _nchw(g)).sum().backward()
    assert got.shape == tx.shape and got.dtype == torch.float32
    _compare(_nhwc(got), want, _exact(policy), f'{policy!r} values')
    _compare(_nhwc(tx.grad), want_grad, _exact(policy), f'{policy!r} grad')
    if not policy:
        assert got is tx


@pytest.mark.parametrize('size', [16, 10])
@pytest.mark.parametrize('name', ['brightness', 'saturation', 'contrast', 'translation',
                                  'cutout'])
def test_each_function_matches_jax(name, size):
    '''One function alone on several keys, so translation and cutout reach
    the border.'''
    jf, tf = getattr(jda, f'rand_{name}'), getattr(tda, f'rand_{name}')
    x = _images(size, seed=2)
    for seed in range(4):
        key = jax.random.PRNGKey(100 + seed)
        want = jf(key, jnp.asarray(x))
        got = tf(_nchw(x), jax_fn_draw(jf, key, x.shape))
        _compare(_nhwc(got), want, name in ('translation', 'cutout'), f'{name} key {seed}')


def test_bf16_images_take_bf16_draws_and_move_exactly():
    '''A bf16 input: JAX draws its uniforms in bf16, and translation and
    cutout move and zero bf16 values bitwise as in JAX.'''
    x = _images(16, seed=3)
    key = jax.random.PRNGKey(7)
    policy = 'translation,cutout'
    want = jda.diff_augment(key, jnp.asarray(x, jnp.bfloat16), policy)
    got = tda.diff_augment(_nchw(x).to(torch.bfloat16), policy,
                           jax_draws(key, x.shape, policy, jnp.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_nhwc(got), np.asarray(want, np.float32))
    assert all(u.dtype == torch.bfloat16
               for u in jax_draws(key, x.shape, 'color', jnp.bfloat16))


@pytest.mark.parametrize('size', [16, 10])
def test_draw_ranges(size):
    n = 4000
    g = torch.Generator().manual_seed(0)
    draws = tda.draw_diff_augment(n, size, size, 'color,translation,cutout', g)
    assert len(draws) == 5
    for u in draws[:3]:
        assert u.shape == (n, 1, 1, 1) and u.dtype == torch.float32
        assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    sh = int(size * 0.125 + 0.5)
    ch = int(size * 0.5 + 0.5)
    for t in draws[3]:
        assert t.shape == (n,)
        assert set(t.tolist()) == set(range(-sh, sh + 1))
    for o in draws[4]:
        assert set(o.tolist()) == set(range(0, size + 1 - ch % 2))
    bf = tda.draw_diff_augment(8, size, size, 'color', g, torch.bfloat16)
    assert all(u.dtype == torch.bfloat16 for u in bf)
    assert tda.draw_diff_augment(8, size, size, '', g) == []


def test_draw_count_is_checked():
    x = torch.zeros(2, 3, 8, 8)
    with pytest.raises(ValueError):
        tda.diff_augment(x, 'color', [])
    with pytest.raises(KeyError):
        tda.policy_fns('colour')
