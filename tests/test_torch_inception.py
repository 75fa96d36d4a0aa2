'''The port's InceptionV3 (`animeface_tpu_torch/metrics/inception.py`)
against the flax `InceptionV3Features`: the resize, the whole network on
weights whose features do not collapse, the `.npz` loader and its error.'''

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animeface_tpu.metrics.inception import InceptionV3Features as JaxInception
from animeface_tpu_torch.convert import convert_inception
from animeface_tpu_torch.convert_weights import inception_npz
from animeface_tpu_torch.metrics import inception as tinc
from tools.convert_inception_weights import convert as tools_convert


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among
    which a full thread pool per process spins many times slower.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _nhwc_to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


@pytest.mark.parametrize('hw', [(64, 64), (320, 320), (256, 320)])
def test_resize_matches_jax_image_resize(hw):
    '''Up, down, and up on one axis with down on the other, to 299.'''
    rng = np.random.default_rng(sum(hw))
    x = rng.uniform(-1, 1, size=(2, *hw, 3)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 299, 299, 3), 'bilinear')
    got = tinc.resize_bilinear(_nhwc_to_nchw(x))
    assert got.shape == (2, 3, 299, 299)
    np.testing.assert_allclose(got.numpy(), _nhwc_to_nchw(want).numpy(), rtol=0, atol=1e-4)


def _random_variables(seed=0, size=75):
    '''flax variables of the right tree from `jax.eval_shape`, filled with
    numpy draws: He-normal kernels, BN scale in [0.8, 1.2], small biases and
    means, variances in [0.5, 1.5] (flax's default init collapses the
    features to std ~3e-6, which would make a comparison vacuous).'''
    shapes = jax.eval_shape(JaxInception(resize_input=False).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path[-1:])
        shape = leaf.shape
        if 'kernel' in name:
            fan_in = shape[0] * shape[1] * shape[2]
            return rng.normal(0, np.sqrt(2.0 / fan_in), size=shape).astype(np.float32)
        if 'scale' in name:
            return rng.uniform(0.8, 1.2, size=shape).astype(np.float32)
        if 'var' in name:
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        return rng.normal(0, 0.1, size=shape).astype(np.float32)     # bias, mean

    return jax.tree_util.tree_map_with_path(fill, jax.tree_util.tree_map(lambda a: a, shapes))


def test_network_matches_flax():
    '''resize_input=False, 75x75, batch 2, f32: within 1e-4 of the
    features' scale.'''
    variables = _random_variables()
    x = np.random.default_rng(1).uniform(-1, 1, size=(2, 75, 75, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxInception(resize_input=False).apply)(variables, x))

    model = tinc.InceptionV3Features(resize_input=False)
    model.load_state_dict(convert_inception(variables))
    with torch.no_grad():
        got = model(_nhwc_to_nchw(x)).numpy()
    assert got.shape == (2, 2048) and got.dtype == np.float32
    scale = np.abs(want).max()
    assert want.std() > 1e-2 * scale          # the features do not collapse
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * scale)


def test_npz_loader_and_converters(tmp_path, monkeypatch):
    '''A file in the converter's layout loads to `convert_inception` of the
    same variables; the port's converter equals the tool's; the extractor
    reads `ANIMEFACE_INCEPTION_WEIGHTS` and gives [B, 2048] on the CPU.'''
    variables = _random_variables(seed=2)
    sd = convert_inception(variables)
    flat = inception_npz(sd)
    want_flat = tools_convert(sd)
    assert sorted(flat) == sorted(want_flat)
    for k, v in want_flat.items():
        np.testing.assert_array_equal(flat[k], v)
    for coll in ('params', 'batch_stats'):
        for path, leaf in jax.tree_util.tree_leaves_with_path(variables[coll]):
            key = coll + '/' + '/'.join(p.key for p in path)
            np.testing.assert_array_equal(flat[key], np.asarray(leaf))

    path = tmp_path / 'inception.npz'
    np.savez(path, **flat)
    monkeypatch.setenv(tinc.WEIGHTS_ENV, str(path))
    assert tinc.inception_available()
    loaded = tinc.load_inception_params()
    assert sorted(loaded) == sorted(sd)
    for k, v in sd.items():
        torch.testing.assert_close(loaded[k], v, rtol=0, atol=0)

    extract = tinc.make_extractor(device='cpu')
    x = torch.from_numpy(np.random.default_rng(3).uniform(-1, 1, (1, 3, 32, 32))
                         .astype(np.float32))
    feats = extract(x)
    assert feats.shape == (1, 2048) and feats.device.type == 'cpu'
    assert bool(torch.isfinite(feats).all())


def test_missing_weights_raise(tmp_path, monkeypatch):
    monkeypatch.setenv(tinc.WEIGHTS_ENV, str(tmp_path / 'absent.npz'))
    assert not tinc.inception_available()
    with pytest.raises(FileNotFoundError, match=tinc.WEIGHTS_ENV):
        tinc.load_inception_params()
    with pytest.raises(FileNotFoundError, match=tinc.WEIGHTS_ENV):
        tinc.make_extractor(device='cpu')
