'''StyleGAN (v1)'s modules of the port against the JAX package, on the CPU
in f32: the mapping, AdaIN, the [1, 2, 1] blur up and down, and G and D at
depths 0-2 in both modes, with `convert_stylegan1_generator` /
`convert_stylegan1_discriminator`, and the blur's adjoint backward.

The JAX models are built to depth 2 at the module's fixed widths (latent
and style width 16, a 2-layer mapping), their biases moved off 0 and every
`noise_scale` moved off its init 0 (or the noise path goes untested). The
noise maps are made with numpy and fed to both sides: the JAX model
module's `jax.random.normal` (the 'noise' rng's draws) returns them
(`NoiseJax`), the port takes them as G's `noise` argument. Outputs agree
at 1e-5 of their scale.
'''

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.StyleGAN import model as jsm
from animeface_tpu_torch.convert import (
    convert_stylegan1_discriminator, convert_stylegan1_generator)
from animeface_tpu_torch.implementations.StyleGAN import model as tsm
from test_torch_pggan import NoiseJax, bridged, close, nchw, nhwc, one_thread, perturb  # noqa: F401

Z, B, DEPTH, MAP = 16, 4, 2, 2


def noise_maps(batch, depth, seed=20):
    '''NCHW numpy maps for G at `depth`, in the port's order.'''
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in tsm.noise_shapes(batch, depth)]


def jax_with_noise(monkeypatch, maps):
    '''The JAX model module's noise draws return `maps` (NCHW) from now on.'''
    monkeypatch.setattr(jsm, 'jax', NoiseJax([m.transpose(0, 2, 3, 1) for m in maps]))


@pytest.fixture(scope='module')
def models():
    jG = jsm.Generator(latent_dim=Z, style_dim=Z, max_depth=DEPTH, map_num_layers=MAP)
    jD = jsm.Discriminator(max_depth=DEPTH)
    G = tsm.Generator(Z, Z, DEPTH, map_num_layers=MAP)
    D = tsm.Discriminator(DEPTH)
    gp, dp = bridged(jG, jD, G, D, convert_stylegan1_generator, convert_stylegan1_discriminator)
    return SimpleNamespace(jG=jG, jD=jD, G=G, D=D, gp=gp, dp=dp)


def _latents(seed):
    return np.random.default_rng(seed).standard_normal((B, Z)).astype(np.float32)


def test_noise_scales_moved_and_names_match(models):
    scales = [float(p) for n, p in models.G.state_dict().items() if n.endswith('noise_scale')]
    assert len(scales) == 2 * (DEPTH + 1) and min(scales) > 0.1
    n_jax = len(jax.tree_util.tree_leaves(models.gp))
    assert len(convert_stylegan1_generator(models.gp)) == n_jax == len(models.G.state_dict())


def test_mapping_matches_jax(models):
    z = _latents(1)
    want = jsm.Mapping(Z, MAP).apply({'params': models.gp['mapping']}, jnp.asarray(z))
    close(models.G.mapping(torch.from_numpy(z)).detach().numpy(), want, what='mapping')


def test_adain_matches_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, 8, 8, 6)).astype(np.float32) * 2 + 0.5
    style = rng.standard_normal((B, Z)).astype(np.float32)
    params = perturb(jsm.AdaIN().init(jax.random.PRNGKey(3), jnp.asarray(x),
                                      jnp.asarray(style))['params'], 4)
    want = jsm.AdaIN().apply({'params': params}, jnp.asarray(x), jnp.asarray(style))
    port = tsm.AdaIN(6, Z)
    dense = params['ELRDense_0']
    port.style.load_state_dict({'weight': torch.from_numpy(np.asarray(dense['kernel']).T.copy()),
                                'bias': torch.from_numpy(np.asarray(dense['bias']))})
    got = nhwc(port(nchw(x), torch.from_numpy(style)))
    close(got, want, what='AdaIN')


@pytest.mark.parametrize('direction', ['up', 'down'])
def test_blur_matches_jax(direction):
    x = np.random.default_rng(5).standard_normal((2, 8, 8, 3)).astype(np.float32)
    jf, tf = ((jsm.upsample_blur, tsm.upsample_blur) if direction == 'up'
              else (jsm.blur_downsample, tsm.blur_downsample))
    want = np.asarray(jf(jnp.asarray(x)))
    got = nhwc(tf(nchw(x)))
    assert got.shape == want.shape == ((2, 16, 16, 3) if direction == 'up' else (2, 4, 4, 3))
    close(got, want, what=f'blur {direction}')


@pytest.mark.parametrize('direction', ['up', 'down'])
def test_blur_backward_is_its_adjoint(direction):
    '''The blur's backward is its own adjoint FIR (`_FIR`), not autograd's
    conv backward: first and second derivatives against finite
    differences in float64, on even and odd sizes, and the forward equal
    to `upsample2d` / `downsample2d`.'''
    from animeface_tpu_torch.ops import downsample2d, setup_filter, upsample2d
    fn, ref = ((tsm.upsample_blur, lambda x: upsample2d(x, setup_filter(tsm._BLUR), up=2))
               if direction == 'up' else
               (tsm.blur_downsample, lambda x: downsample2d(x, setup_filter(tsm._BLUR), down=2)))
    g = torch.Generator().manual_seed(6)
    for shape in ((2, 3, 6, 6), (1, 2, 7, 5)):
        x = torch.randn(shape, generator=g, dtype=torch.float64, requires_grad=True)
        assert torch.autograd.gradcheck(fn, (x,)) and torch.autograd.gradgradcheck(fn, (x,))
        x32 = x.detach().float()
        assert torch.equal(fn(x32), ref(x32))


@pytest.mark.parametrize('mode', ['s', 't'])
@pytest.mark.parametrize('depth', [0, 1, 2])
def test_generator_matches_jax(models, monkeypatch, depth, mode):
    z, maps = _latents(depth), noise_maps(B, depth, seed=30 + depth)
    jax_with_noise(monkeypatch, maps)
    want = models.jG.apply({'params': models.gp}, jnp.asarray(z), depth=depth, mode=mode,
                           alpha=0.3, rngs={'noise': jax.random.PRNGKey(0)})
    with torch.no_grad():
        got = models.G(torch.from_numpy(z), depth, mode, 0.3,
                       noise=[torch.from_numpy(m) for m in maps])
        silent = models.G(torch.from_numpy(z), depth, mode, 0.3,
                          noise=[torch.zeros_like(torch.from_numpy(m)) for m in maps])
    close(nhwc(got), want, what=f'G depth {depth} mode {mode}')
    assert float((got - silent).abs().max()) > 1e-2 * float(got.abs().max())   # noise matters


@pytest.mark.parametrize('mode', ['s', 't'])
@pytest.mark.parametrize('depth', [0, 1, 2])
def test_discriminator_matches_jax(models, depth, mode):
    size = 4 * 2 ** depth
    x = np.random.default_rng(40 + depth).standard_normal((B, size, size, 3)).astype(np.float32)
    want = models.jD.apply({'params': models.dp}, jnp.asarray(x), depth=depth, mode=mode,
                           alpha=0.3)
    with torch.no_grad():
        got = models.D(nchw(x), depth, mode, 0.3)
    close(got.numpy(), want, what=f'D depth {depth} mode {mode}')
