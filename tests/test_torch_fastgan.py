'''FastGAN in the port against `animeface_tpu/implementations/FastGAN/`: the
converters, and G and D forwards in train and eval mode (D at each part
quadrant), with the spectral norm's u and the BatchNorm running statistics
they leave. The training step's twin is `tests/test_torch_fastgan_step.py`.

Small configurations, f32 on the CPU, weights from flax `init` with every
BatchNorm's statistics and affine moved off their init values (seeded
numpy), so eval mode reads real running statistics: G at 32px (3 up
blocks 16..4 wide, one SLE), D at 32px (2 residual blocks, decoders to
16px: the full-image target is a 2x nearest down) with BatchNorm, and at
128px (2 stem convs, decoders to 32px: 4x and 2x nearest downs) with
'in'. Tolerance 1e-5 of the output's scale (the same f32 convolutions
summed in another order).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.FastGAN import model as jm
from animeface_tpu_torch.convert import (
    convert_fastgan_discriminator, convert_fastgan_generator)
from animeface_tpu_torch.implementations.FastGAN import model as tm
from animeface_tpu_torch.implementations.FastGAN import utils as tu
from test_torch_step import _close, _nchw

FWD_RTOL = 1e-5
B, Z = 8, 8
GCFG = dict(latent_dim=Z, image_size=32, channels=4, max_channels=16)
DCFGS = {'bn32': dict(image_size=32, init_down_size=32, channels=4, max_channels=16,
                      decoder_image_size=16),
         'in128': dict(image_size=128, init_down_size=32, channels=4, max_channels=16,
                       decoder_image_size=32, norm_name='in')}


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _perturb_stats(variables, seed):
    '''Move every BatchNorm's scale, bias, mean and var off its init.'''
    rng = np.random.default_rng(seed)

    def move(path, a):
        key = str(path[-1].key)
        a = np.array(a)
        if key in ('scale', 'var'):
            return (a * rng.uniform(0.5, 1.5, a.shape)).astype(np.float32)
        if key in ('bias', 'mean') and 'BatchNorm_0' in str(path):
            return (a + rng.standard_normal(a.shape) * 0.2).astype(np.float32)
        return a
    return jax.tree_util.tree_map_with_path(move, jax.device_get(variables))


def _port_g(variables, cfg=GCFG):
    G = tm.Generator(**cfg)
    G.load_state_dict(convert_fastgan_generator(variables))
    return G


def _port_d(variables, cfg):
    D = tm.Discriminator(**cfg)
    D.load_state_dict(convert_fastgan_discriminator(variables))
    return D


def _check_state(module, variables, convert, rtol=FWD_RTOL, what=''):
    '''Every entry of the port's state_dict (params, u, running stats)
    against the converted JAX variables.'''
    want = convert(variables)
    got = module.state_dict()
    assert set(got) == set(want)
    for name, v in got.items():
        _close(v.numpy(), want[name].numpy(), rtol=rtol, what=f'{what} {name}')


@pytest.fixture(scope='module')
def gvars():
    jG = jm.Generator(**GCFG)
    v = jax.jit(lambda k: jG.init({'params': k}, jnp.zeros((2, Z)), train=True))(
        jax.random.PRNGKey(0))
    return jG, _perturb_stats(v, 1)


@pytest.fixture(scope='module')
def dvars():
    out = {}
    for name, cfg in DCFGS.items():
        jD = jm.Discriminator(**cfg)
        S = cfg['image_size']
        v = jax.jit(lambda k: jD.init({'params': k, 'part': k}, jnp.zeros((2, S, S, 3)),
                                      train=True))(jax.random.PRNGKey(2))
        out[name] = (jD, _perturb_stats(v, 3))
    return out


def test_transposed_is_refused():
    with pytest.raises(NotImplementedError, match='ConvTranspose'):
        tm.Generator(**GCFG, transposed=True)
    with pytest.raises(NotImplementedError):
        tu.build_models(tu.default_args(transposed=True), device='cpu')


def test_converters_cover_every_entry(gvars, dvars):
    G = tm.Generator(**GCFG)
    assert set(convert_fastgan_generator(gvars[1])) == set(G.state_dict())
    assert len(G.sles) == 1 and len(G.ups) == 3
    for name, cfg in DCFGS.items():
        D = tm.Discriminator(**cfg)
        assert set(convert_fastgan_discriminator(dvars[name][1])) == set(D.state_dict()), name
    assert len(tm.Discriminator(**DCFGS['in128']).stem_norms) == 1


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_generator_matches_jax(gvars, train):
    jG, v = gvars
    z = np.random.default_rng(4).standard_normal((B, Z)).astype(np.float32)
    G = _port_g(v)
    if train:
        want, mut = jG.apply(v, jnp.asarray(z), train=True, mutable=['batch_stats'])
        new_v = dict(v, **jax.device_get(mut))
    else:
        want, new_v = jG.apply(v, jnp.asarray(z), train=False), v
    with torch.no_grad():
        got = G(torch.from_numpy(z), train=train)
    assert got.shape == (B, 3, 32, 32) and got.dtype == torch.float32
    _close(_nhwc(got), want, what=f'G train={train}')
    _check_state(G, new_v, convert_fastgan_generator, what='G state')


@pytest.mark.parametrize('qid', [0, 1, 2, 3])
@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('cfg', list(DCFGS))
def test_discriminator_matches_jax(dvars, cfg, train, qid):
    '''Logits, the reconstruction loss and the four recon images at a
    quadrant JAX picks from a found part key.'''
    jD, v = dvars[cfg]
    S = DCFGS[cfg]['image_size']
    part_key = next(k for k in (jax.random.PRNGKey(i) for i in range(64))
                    if int(jax.random.randint(k, (), 0, 4)) == qid)
    x = np.random.default_rng(5).uniform(-1, 1, (B, S, S, 3)).astype(np.float32)
    kw = dict(part_key=part_key, train=train)
    if train:
        (logits, recon_loss, recons), mut = jD.apply(v, jnp.asarray(x), mutable=['batch_stats'],
                                                     **kw)
        new_v = dict(v, **jax.device_get(mut))
    else:
        (logits, recon_loss, recons), new_v = jD.apply(v, jnp.asarray(x), **kw), v
    D = _port_d(v, DCFGS[cfg])
    with torch.no_grad():
        got_logits, got_loss, got_recons = D(_nchw(x), qid, train=train)
        got_only = D(_nchw(x), train=train) if not train else None
    _close(got_logits.numpy(), logits, what='logits')
    _close(float(got_loss), float(recon_loss), what='recon loss')
    for what, g, w in zip(('recon', 'small', 'recon_part', 'img_part'), got_recons, recons):
        assert g.shape == _nchw(np.asarray(w)).shape, what
        _close(_nhwc(g), w, what=what)
    if train:
        _check_state(D, new_v, convert_fastgan_discriminator, what='D state')
    else:
        _close(got_only.numpy(), logits, what='logits without decoders')


def test_quadrant_takes_a_tensor():
    x = torch.arange(2 * 3 * 8 * 8, dtype=torch.float32).reshape(2, 3, 8, 8)
    for q, (r, c) in enumerate(((0, 0), (4, 0), (0, 4), (4, 4))):
        want = x[:, :, r:r + 4, c:c + 4]
        assert torch.equal(tm.quadrant(x, q), want)
        assert torch.equal(tm.quadrant(x, torch.tensor(q)), want)
