'''The port's FID and KID (`animeface_tpu_torch/metrics/fid.py`) against the
committed canned features and the JAX package's `metrics/fid.py`.'''

import os

import numpy as np
import pytest
import torch

from animeface_tpu.metrics import fid as jfid
from animeface_tpu_torch.metrics import fid as tfid


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among
    which a full thread pool per process spins many times slower.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

CANNED = os.path.join(os.path.dirname(__file__), 'data', 'fid_canned_features.npz')


@pytest.fixture(scope='module')
def canned():
    with np.load(CANNED) as data:
        return {k: data[k] for k in data.files}


def test_canned_fid_and_kid_match_expected(canned):
    '''The JAX test's tolerances on `tests/data/fid_canned_features.npz`:
    pytorch-fid's FID (scipy sqrtm) and the unbiased cubic-kernel KID.'''
    real, fake = canned['real'], canned['fake']
    mu_r, s_r = tfid.gaussian_statistics(real)
    mu_f, s_f = tfid.gaussian_statistics(fake)
    got_fid = tfid.frechet_distance(mu_r, s_r, mu_f, s_f)
    np.testing.assert_allclose(got_fid, float(canned['expected_fid']), rtol=1e-8, atol=1e-6)

    got_kid = tfid.compute_kid(real, fake, num_subsets=1, subset_size=len(real))
    np.testing.assert_allclose(got_kid, float(canned['expected_kid']), rtol=1e-8, atol=1e-9)


def test_canned_statistics_match_numpy_and_jax(canned):
    real = canned['real']
    mu, cov = tfid.gaussian_statistics(real)
    assert mu.dtype == cov.dtype == torch.float64
    x = real.astype(np.float64)
    np.testing.assert_allclose(mu.numpy(), x.mean(0), rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(cov.numpy(), np.cov(x, rowvar=False), rtol=1e-10, atol=1e-12)
    mu_j, cov_j = jfid.gaussian_statistics(real)
    np.testing.assert_allclose(cov.numpy(), cov_j, rtol=1e-12, atol=1e-13)


def test_kid_100_subsets_matches_jax(canned):
    '''The subsets come from numpy's `default_rng(seed).choice` in both.'''
    real, fake = canned['real'], canned['fake']
    for seed, size in ((0, 1000), (3, 200)):
        want = jfid.compute_kid(real, fake, num_subsets=100, subset_size=size, seed=seed)
        got = tfid.compute_kid(torch.from_numpy(real), fake, num_subsets=100,
                               subset_size=size, seed=seed)
        np.testing.assert_allclose(got, want, rtol=1e-10)


def test_streaming_equals_batch():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(333, 8))
    acc = tfid.FeatureAccumulator(8)
    for i in range(0, 333, 50):
        acc.update(torch.from_numpy(x[i:i + 50]).float())
    mu_s, cov_s = acc.statistics()
    mu_b, cov_b = tfid.gaussian_statistics(x.astype(np.float32))
    np.testing.assert_allclose(mu_s.numpy(), mu_b.numpy(), atol=1e-10)
    np.testing.assert_allclose(cov_s.numpy(), cov_b.numpy(), atol=1e-8)
    with pytest.raises(ValueError):
        acc.update(np.zeros((4, 7)))


def test_frechet_matches_jax_on_spd_matrices():
    rng = np.random.default_rng(2)
    d = 12
    a, b = rng.normal(size=(d, d)), rng.normal(size=(d, d))
    s1, s2 = a @ a.T + np.eye(d) * 0.1, b @ b.T + np.eye(d) * 0.1
    mu1, mu2 = rng.normal(size=d), rng.normal(size=d)
    want = jfid.frechet_distance(mu1, s1, mu2, s2)
    np.testing.assert_allclose(tfid.frechet_distance(mu1, s1, mu2, s2), want, rtol=1e-10)
    assert abs(tfid.frechet_distance(mu1, s1, mu1, s1)) < 1e-8


def _moments_nhwc(images):
    x = np.asarray(images, np.float64)
    return np.concatenate([x.mean(axis=(1, 2)), (x ** 2).mean(axis=(1, 2))], axis=1)


def _moments_nchw(images):
    x = images.double()
    return torch.cat([x.mean(dim=(2, 3)), (x ** 2).mean(dim=(2, 3))], dim=1)


def test_compute_fid_matches_jax():
    '''The same numpy batches through the same extractor (per-channel first
    and second moments; NHWC for JAX, NCHW for the port), batches of 64
    cut at 300 samples.'''
    rng = np.random.default_rng(4)
    real = np.tanh(rng.normal(size=(320, 8, 8, 3)))
    fake = np.tanh(rng.normal(0.5, 1.5, size=(320, 8, 8, 3)))

    def batches(arr, nchw):
        for i in range(0, len(arr), 64):
            b = arr[i:i + 64]
            yield torch.from_numpy(b.transpose(0, 3, 1, 2)) if nchw else b

    want = jfid.compute_fid(batches(real, False), batches(fake, False), _moments_nhwc,
                            num_samples=300)
    got = tfid.compute_fid(batches(real, True), batches(fake, True), _moments_nchw,
                           num_samples=300)
    assert want > 0.1
    np.testing.assert_allclose(got, want, rtol=1e-10)
    with pytest.raises(ValueError, match='no fake samples'):
        tfid.compute_fid(batches(real, True), iter(()), _moments_nchw, num_samples=300)
