'''The port's random-VGG trend metric (`animeface_tpu_torch/metrics/trend.py`)
against the JAX package's `metrics/trend.py`.'''

import numpy as np
import pytest
import torch

from animeface_tpu.metrics import trend as jtrend
from animeface_tpu_torch.convert import convert_vgg
from animeface_tpu_torch.metrics import trend as ttrend
from test_torch_vgg import jax_fallback_variables


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among
    which a full thread pool per process spins many times slower.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trend_images(seed):
    rng = np.random.default_rng(seed)
    xs = np.linspace(-1, 1, 16)
    grid = xs[None, :, None, None] * xs[None, None, :, None]
    data = np.tanh(grid + 0.3 * rng.normal(size=(64, 16, 16, 3)))
    near = np.tanh(grid + 0.3 * rng.normal(size=(64, 16, 16, 3)))
    noise = rng.uniform(-1, 1, size=(64, 16, 16, 3))
    return [a.astype(np.float32) for a in (data, near, noise)]


def test_trend_matches_jax():
    '''`make_trend_extractor` on the JAX extractor's own variables: the 1472
    features within 1e-4 of their scale, and `trend_fd` of the two streams.'''
    data, near, noise = _trend_images(0)
    jextract = jtrend.make_trend_extractor()
    variables = jax_fallback_variables()      # the JAX extractor's own
    textract = ttrend.make_trend_extractor(convert_vgg(variables['params']), device='cpu')

    def nchw(a):
        return torch.from_numpy(a.transpose(0, 3, 1, 2).copy())

    want = np.asarray(jextract(data))
    got = textract(nchw(data)).numpy()
    assert got.shape == (64, ttrend.FEATURE_DIM) == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())

    for other in (near, noise):
        fd_want = jtrend.trend_fd(jtrend.trend_statistics([data], jextract, max_samples=64),
                                  jtrend.trend_statistics([other], jextract, max_samples=64))
        fd_got = ttrend.trend_fd(
            ttrend.trend_statistics([nchw(data)], textract, max_samples=64),
            ttrend.trend_statistics([nchw(other)], textract, max_samples=64))
        np.testing.assert_allclose(fd_got, fd_want, rtol=1e-4)


def test_trend_features_discriminate():
    '''The port's own fallback (torch-drawn weights) discriminates as the
    JAX one does: identical streams ~0, near streams small, noise far.'''
    data, near, noise = (torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
                         for a in _trend_images(1))
    extract = ttrend.make_trend_extractor(device='cpu')
    stats = [ttrend.trend_statistics([x], extract, max_samples=64) for x in (data, near, noise)]
    fd_same = ttrend.trend_fd(stats[0], stats[0])
    fd_near = ttrend.trend_fd(stats[0], stats[1])
    fd_far = ttrend.trend_fd(stats[0], stats[2])
    assert fd_same < 1e-6 and fd_near > 0
    assert fd_far > 10 * fd_near, (fd_near, fd_far)
