'''PGGAN's G and D of the port against the JAX package, on the CPU in f32,
and `convert_pggan_generator` / `convert_pggan_discriminator`.

The JAX models are built to depth 2 (16px) at the module's fixed widths
(512 to 256 channels) with `init_all`, their biases moved off 0, and
bridged by `convert.py`; latents and images are made from seeds with
numpy. Outputs agree at 1e-5 of their scale (f32 through a few
convolutions in two frameworks). The helpers here (`bridged`, `perturb`,
`NoiseJax`) serve the StyleGAN and step files too.
'''

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.implementations.PGGAN import model as jm
from animeface_tpu_torch.convert import convert_pggan_discriminator, convert_pggan_generator
from animeface_tpu_torch.implementations.PGGAN import model as tm

RTOL = 1e-5
Z, B, DEPTH = 16, 4, 2


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among which
    a full thread pool per process spins many times slower (as in
    tests/test_torch_fid_cli.py). Imported by the other progressive files.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, rtol=RTOL, what=''):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= rtol * scale, f'{what}: max abs err {err} vs scale {scale}'


def perturb(params, seed):
    '''Biases moved off 0 by N(0, 0.1), each `noise_scale` to U[0.2, 0.8).'''
    rng = np.random.default_rng(seed)

    def move(path, a):
        key = str(path[-1].key)
        a = np.array(a, np.float32)
        if key == 'bias':
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
        if key == 'noise_scale':
            return np.float32(rng.uniform(0.2, 0.8))
        return a
    return jax.tree_util.tree_map_with_path(move, jax.device_get(params))


def bridged(jG, jD, G, D, convert_g, convert_d):
    '''JAX G and D params from `init_all` (biases moved) and the port's
    G and D loaded with them.'''
    gp = perturb(jG.init_all(jax.random.PRNGKey(0))['params'], 1)
    dp = perturb(jD.init_all(jax.random.PRNGKey(1))['params'], 2)
    G.load_state_dict(convert_g(gp))
    D.load_state_dict(convert_d(dp))
    return gp, dp


class NoiseJax:
    '''Stands in for the `jax` module of a JAX model module: every
    `jax.random.normal` call returns the next of `maps` (NHWC, cycling, so
    two G calls of one step see the same maps); all else is `jax`.'''

    def __init__(self, maps):
        self.maps, self.calls = [np.asarray(m) for m in maps], 0
        self.random = SimpleNamespace(normal=self._normal)

    def __getattr__(self, name):
        return getattr(jax, name)

    def _normal(self, key, shape, dtype=jnp.float32):
        m = self.maps[self.calls % len(self.maps)]
        self.calls += 1
        assert m.shape == tuple(shape), (m.shape, shape)
        return jnp.asarray(m, dtype)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.fixture(scope='module')
def models():
    jG, jD = jm.Generator(latent_dim=Z, max_depth=DEPTH), jm.Discriminator(max_depth=DEPTH)
    G, D = tm.Generator(Z, DEPTH), tm.Discriminator(DEPTH)
    gp, dp = bridged(jG, jD, G, D, convert_pggan_generator, convert_pggan_discriminator)
    return SimpleNamespace(jG=jG, jD=jD, G=G, D=D, gp=gp, dp=dp)


@pytest.mark.parametrize('mode', ['s', 't'])
@pytest.mark.parametrize('depth', [0, 1, 2])
def test_generator_matches_jax(models, depth, mode):
    z = np.random.default_rng(depth).standard_normal((B, Z)).astype(np.float32)
    want = models.jG.apply({'params': models.gp}, jnp.asarray(z), depth=depth, mode=mode,
                           alpha=0.3)
    with torch.no_grad():
        got = models.G(torch.from_numpy(z), depth, mode, 0.3)
    assert got.dtype == torch.float32
    close(nhwc(got), want, what=f'G depth {depth} mode {mode}')


@pytest.mark.parametrize('mode', ['s', 't'])
@pytest.mark.parametrize('depth', [0, 1, 2])
def test_discriminator_matches_jax(models, depth, mode):
    size = 4 * 2 ** depth
    x = np.random.default_rng(10 + depth).standard_normal((B, size, size, 3)).astype(np.float32)
    want = models.jD.apply({'params': models.dp}, jnp.asarray(x), depth=depth, mode=mode,
                           alpha=0.3)
    with torch.no_grad():
        got = models.D(nchw(x), depth, mode, 0.3)
    close(got.numpy(), want, what=f'D depth {depth} mode {mode}')


def test_converters_round_trip(models):
    '''Every port parameter comes from one JAX parameter with its raw
    values (the runtime coefficients stay in the modules): the names match
    exactly, and each tensor is its JAX array transposed.'''
    g, d = convert_pggan_generator(models.gp), convert_pggan_discriminator(models.dp)
    assert set(g) == set(models.G.state_dict()) and set(d) == set(models.D.state_dict())
    n_jax = len(jax.tree_util.tree_leaves(models.gp)) + len(jax.tree_util.tree_leaves(models.dp))
    assert len(g) + len(d) == n_jax
    for d_ in range(DEPTH + 1):
        block = models.gp[f'block_{d_}']
        for i in range(len(block) - ('kernel_t' in block)):
            conv = block[f'ELRConv_{i}']
            np.testing.assert_array_equal(g[f'blocks.{d_}.convs.{i}.weight'].numpy(),
                                          np.asarray(conv['kernel']).transpose(3, 2, 0, 1))
            np.testing.assert_array_equal(g[f'blocks.{d_}.convs.{i}.bias'].numpy(),
                                          np.asarray(conv['bias']))
        head = models.dp[f'from_rgb_{d_}']
        np.testing.assert_array_equal(d[f'from_rgb.{d_}.weight'].numpy(),
                                      np.asarray(head['kernel']).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        g['blocks.0.kernel_t'].numpy(),
        np.asarray(models.gp['block_0']['kernel_t'])[::-1, ::-1].transpose(2, 3, 0, 1))


def test_first_block_needs_the_kernel_flip():
    '''G's first layer against `jax.lax.conv_transpose` of the 1x1 latent
    with an asymmetric [4, 4, 5, 3] kernel: equal with the converter's
    flip, and far off without it (a converter that dropped the flip would
    fail the forward tests above).'''
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 1, 1, 5)).astype(np.float32)
    k = rng.standard_normal((4, 4, 5, 3)).astype(np.float32)
    want = np.asarray(jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(k), (1, 1), 'VALID',
                                             dimension_numbers=('NHWC', 'HWIO', 'NHWC')))
    block = tm.GBlock(5, 3, is_first=True)
    params = {'block_0': {'kernel_t': k}}
    flipped = convert_pggan_generator(params)['blocks.0.kernel_t']
    for weight, agree in ((flipped, True), (torch.from_numpy(k.transpose(2, 3, 0, 1)), False)):
        got = nhwc(torch.nn.functional.conv_transpose2d(nchw(x), weight))
        err = float(np.abs(got - want).max())
        assert (err <= RTOL * float(np.abs(want).max())) == agree, err
    assert block.kernel_t.shape == flipped.shape


def test_minibatch_std_matches_jnp_std():
    '''The population std (ddof 0) over a batch of 4, as `jnp.std`; the
    unbiased one differs by 15%.'''
    x = np.random.default_rng(4).standard_normal((4, 4, 4, 6)).astype(np.float32)
    want = np.asarray(jm.MiniBatchStd().apply({}, jnp.asarray(x)))
    got = nhwc(tm.MiniBatchStd()(nchw(x)))
    close(got, want, what='MiniBatchStd')
    stat = float(want[0, 0, 0, -1])
    unbiased = float(np.std(x, axis=0, ddof=1).mean())
    assert abs(unbiased - stat) > 0.05 * stat
