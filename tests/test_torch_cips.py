'''CIPS in the port against the JAX package: the generator through the
weight bridge, under both of the ops registry's implementations, the
recipe's sampler, and the count of kernel calls a forward makes.

The JAX generator runs with its registry set to 'pallas', so every
`bias_act` in scope runs `bias_act_pallas` in interpret mode; the port runs
with 'torch' and with 'cuda' (on CPU tensors: the kernels' plain versions).
Same seeded numpy inputs on both sides, f32 on the CPU. The small model
keeps every layer in the kernel's scope: image 8, 2 layers, channels 128,
latent/style 128, batch 8. Tolerance: 1e-5 of the output's scale (the same
f32 matmuls summed in another order through 3 StyleLayers, and the sin of
the Fourier input).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

import animeface_tpu.ops.registry as jregistry
from animeface_tpu.ops import pallas_kernels as jpk
from animeface_tpu.implementations.CIPS import model as jm
from animeface_tpu_torch.convert import convert_cips_generator
from animeface_tpu_torch.implementations.CIPS import model as tm
from animeface_tpu_torch.implementations.CIPS.utils import (
    build_models, default_args, make_sampler)
from animeface_tpu_torch.ops import cuda_kernels as ck
from animeface_tpu_torch.ops import registry

RTOL = 1e-5
GCFG = dict(image_size=8, latent_dim=128, style_dim=128, num_layers=2, channels=64,
            max_channels=128)
B = 8


def _close(got, want, rtol=RTOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f'{what}: max abs err {err} vs scale {scale}'


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope='module')
def gen():
    jG = jm.Generator(**GCFG)
    v = jax.device_get(jax.jit(jG.init)(jax.random.PRNGKey(0), jnp.zeros((1, 128))))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: (np.asarray(a) + rng.standard_normal(a.shape).astype(np.float32) * 0.1
                         if path[-1].key == 'bias' else np.asarray(a)), v['params'])
    moments = {'w_avg': rng.standard_normal(128).astype(np.float32)}
    tG = tm.Generator(**GCFG)
    tG.load_state_dict(convert_cips_generator(params, moments))
    return jG, params, moments, tG


def test_generator_layers_and_names(gen):
    jG, params, moments, tG = gen
    assert len(tG.layers) == 3 and len(tG.to_rgbs) == 1 and len(tG.map.layers) == 4
    assert tG.layers[0].fc.weight.shape == (256, 128)          # Fourier + constants in
    assert set(convert_cips_generator(params, moments)) == set(tG.state_dict())
    assert 'map.w_avg' in dict(tG.named_buffers())


@pytest.mark.parametrize('impl', ['torch', 'cuda'])
def test_generator_matches_jax_pallas(gen, impl, monkeypatch):
    '''G(z) and G(z, truncation_psi=0.7) in the port under `impl` against
    the JAX G with its registry on 'pallas'.'''
    jG, params, moments, tG = gen
    z = np.random.default_rng(1).standard_normal((B, 128)).astype(np.float32)
    monkeypatch.setattr(jregistry, '_default_impl', 'pallas')
    monkeypatch.setattr(registry, '_default_impl', impl)
    for psi in (1.0, 0.7):
        want = jG.apply({'params': params, 'moments': moments}, jnp.asarray(z),
                        truncation_psi=psi)
        with torch.no_grad():
            got = tG(torch.from_numpy(z), truncation_psi=psi)
        assert got.shape == (B, 3, 8, 8) and got.dtype == torch.float32
        _close(_nhwc(got), want, what=f'G(z) psi {psi}')


def test_generator_gradients_and_moments_match_jax(gen):
    '''Under the default implementations: the gradients of every parameter
    and of z, and the w_avg update of a forward with train=True.'''
    jG, params, moments, tG = gen
    z = np.random.default_rng(2).standard_normal((B, 128)).astype(np.float32)
    g = np.random.default_rng(3).standard_normal((B, 8, 8, 3)).astype(np.float32)

    def jfn(p, zz):
        out, mut = jG.apply({'params': p, 'moments': moments}, zz, train=True,
                            mutable=['moments'])
        return jnp.sum(out * g), mut['moments']

    (_, new_m), (wgp, wgz) = jax.jit(jax.value_and_grad(jfn, argnums=(0, 1), has_aux=True))(
        params, jnp.asarray(z))
    tG.load_state_dict(convert_cips_generator(params, moments))
    tG.zero_grad(set_to_none=True)
    tz = torch.from_numpy(z).requires_grad_(True)
    out = tG(tz, train=True)
    (out * torch.from_numpy(g.transpose(0, 3, 1, 2).copy())).sum().backward()
    _close(tz.grad.numpy(), wgz, what='dz')
    want_grads = convert_cips_generator(wgp, moments)
    for name, p in tG.named_parameters():
        _close(p.grad.numpy(), want_grads[name].numpy(), what=f'grad {name}')
    _close(tG.map.w_avg.numpy(), np.asarray(new_m['w_avg']), what='w_avg')
    tG.load_state_dict(convert_cips_generator(params, moments))


def test_kernel_calls_per_forward_at_recipe_depth(monkeypatch):
    '''At the recipe's depth (14 layers, 4 mapping layers; narrow widths),
    a forward under 'cuda' sends 41 calls to the bias_act kernel (counting
    stand-in on the CPU): 4 mapping + 15 StyleLayer affines + 7 RGB affines
    + 15 StyleLayers; the bias-free Fourier projection is out of scope. The
    JAX G, traced abstractly under 'pallas', runs `bias_act_pallas` as
    often.'''
    cfg = dict(GCFG, num_layers=14)
    calls = []

    def counting(x, b, dim, act, alpha, gain, clamp):
        calls.append(tuple(x.shape))
        return ck.bias_act_plain(x, b, dim, act, alpha, gain, clamp)

    monkeypatch.setattr(ck, 'bias_act', counting)
    monkeypatch.setattr(registry, '_default_impl', 'cuda')
    tG = tm.Generator(**cfg, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        out = tG(torch.zeros((B, 128)))
    assert out.shape == (B, 3, 8, 8)
    assert len(calls) == 41
    assert calls.count((B, 64, 128)) == 15 and calls.count((B, 128)) == 4 + 14 + 7

    jcalls = []
    real = jpk.bias_act_pallas

    def jcounting(*args):
        out = real(*args)
        jcalls.append(out is not None)
        return out

    monkeypatch.setattr(jpk, 'bias_act_pallas', jcounting)
    monkeypatch.setattr(jregistry, '_default_impl', 'pallas')
    jG = jm.Generator(**cfg)
    jax.eval_shape(lambda z: jG.init_with_output(jax.random.PRNGKey(0), z), jnp.zeros((B, 128)))
    assert sum(jcalls) == 41


def test_sampler_is_the_recipe_sample_fn():
    '''`make_sampler`: G_ema on `num_test` fixed latents, without a graph,
    the same images on every call; under 'cuda' (plain versions on the CPU)
    equal to 'torch' in f32; the registry's default is restored.'''
    args = default_args(image_size=8, num_layers=2, g_channels=64, g_max_channels=128,
                        latent_dim=128, style_dim=128, num_test=8, no_bf16=True)
    G, D, G_ema = build_models(args, device='cpu')
    assert G_ema.layers[0].fc.dtype == torch.float32 and not any(
        p.requires_grad for p in G_ema.parameters())
    samples = {impl: make_sampler(G_ema, args, seed=3, impl=impl) for impl in ('torch', 'cuda')}
    images = samples['cuda']()
    assert registry.get_default_impl() == 'torch'
    assert images.shape == (8, 3, 8, 8) and not images.requires_grad
    torch.testing.assert_close(samples['cuda'](), images, rtol=0, atol=0)
    _close(samples['torch']().numpy(), images.numpy(), what="'torch' vs 'cuda'")
    assert D(images).shape == (8, 1)


def test_build_models_bf16_and_without_card(monkeypatch):
    args = default_args(image_size=8, num_layers=2, g_channels=64, g_max_channels=128,
                        latent_dim=128, style_dim=128, num_test=8)
    G, D, G_ema = build_models(args, device='cpu')
    assert G.layers[1].fc.dtype == torch.bfloat16 and G.map.layers[0].dtype == torch.float32
    images = make_sampler(G_ema, args, impl='cuda')()
    assert images.dtype == torch.float32 and bool(torch.isfinite(images).all())
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        build_models(args)
    with pytest.raises(TypeError):
        default_args(num_steps=3)
