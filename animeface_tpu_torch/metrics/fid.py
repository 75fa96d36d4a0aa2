'''Frechet Inception Distance / Kernel Inception Distance.

Counterpart of `animeface_tpu/metrics/fid.py`: the FID-50k protocol with
pytorch-fid's semantics (InceptionV3 pool3 features of 2048 dims, the
Frechet distance with the matrix square root of the covariance product)
and KID as StyleGAN2-ADA computes it.

The statistics are accumulated in float64 on the features' device (the
JAX package keeps them on the host only because TPUs have no f64), and the
Frechet distance and KID's kernel products run there in float64 too, so
they equal numpy's evaluation of the same formulas. KID's subsets are
drawn with numpy's `default_rng(seed).choice`, exactly as the JAX package
draws them, so the same features give the same KID in both.
'''

from __future__ import annotations

import numpy as np
import torch


def _f64(x, device=None) -> torch.Tensor:
    '''`x` (a tensor or an array) as a float64 tensor, on its own device
    unless `device` is given.'''
    t = torch.as_tensor(x)
    return t.to(device=t.device if device is None else device, dtype=torch.float64)


# ---------------- statistics ----------------

class FeatureAccumulator:
    '''Streaming mean/covariance over feature batches (float64, on the
    device of the first batch).'''

    def __init__(self, dim: int):
        self.dim = dim
        self.n = 0
        self.s1 = self.s2 = None

    def update(self, feats) -> None:
        f = _f64(feats, None if self.s1 is None else self.s1.device)
        if f.ndim != 2 or f.shape[1] != self.dim:
            raise ValueError(f'features of shape {tuple(f.shape)}, expected [N, {self.dim}]')
        if self.s1 is None:
            self.s1 = torch.zeros(self.dim, dtype=torch.float64, device=f.device)
            self.s2 = torch.zeros((self.dim, self.dim), dtype=torch.float64, device=f.device)
        self.n += f.shape[0]
        self.s1 += f.sum(dim=0)
        self.s2 += f.T @ f

    def statistics(self):
        '''(mu [D], cov [D, D]) as float64 tensors.'''
        if self.n < 2:
            raise ValueError('need >= 2 samples for covariance')
        mu = self.s1 / self.n
        # unbiased covariance, matching np.cov / pytorch-fid
        cov = (self.s2 - self.n * torch.outer(mu, mu)) / (self.n - 1)
        return mu, cov


def gaussian_statistics(features):
    '''(mu, cov) of [N, D] features, float64, unbiased (pytorch-fid).'''
    acc = FeatureAccumulator(torch.as_tensor(features).shape[1])
    acc.update(features)
    return acc.statistics()


def _sqrtm_psd(mat: torch.Tensor) -> torch.Tensor:
    '''Matrix square root through the eigendecomposition of the
    symmetrized matrix (the JAX package's `_sqrtm_psd`): the matrices it is
    given are PSD up to noise, whose negative eigenvalues are clipped.'''
    sym = (mat + mat.T) / 2.0
    vals, vecs = torch.linalg.eigh(sym)
    return (vecs * torch.sqrt(vals.clamp(min=0.0))) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    '''d^2 = |mu1-mu2|^2 + Tr(s1 + s2 - 2 sqrt(s1 s2)) (pytorch-fid), on
    the device of `sigma1` in float64.'''
    device = torch.as_tensor(sigma1).device
    mu1, mu2, sigma1, sigma2 = (_f64(a, device) for a in (mu1, mu2, sigma1, sigma2))

    diff = mu1 - mu2
    # sqrt(s1 s2) has the same trace as sqrt(s2^(1/2) s1 s2^(1/2)), which is PSD
    s2_half = _sqrtm_psd(sigma2)
    tr_covmean = torch.trace(_sqrtm_psd(s2_half @ sigma1 @ s2_half))

    if not bool(torch.isfinite(tr_covmean)):
        offset = torch.eye(sigma1.shape[0], dtype=torch.float64, device=device) * eps
        s2_half = _sqrtm_psd(sigma2 + offset)
        tr_covmean = torch.trace(_sqrtm_psd(s2_half @ (sigma1 + offset) @ s2_half))

    return float(diff @ diff + torch.trace(sigma1) + torch.trace(sigma2) - 2.0 * tr_covmean)


# ---------------- pipelines ----------------

def _feature_stream(batches, extract_fn, max_samples: int):
    '''Yield feature tensors from image batches until max_samples reached.'''
    seen = 0
    for batch in batches:
        if seen >= max_samples:
            break
        imgs = batch[0] if isinstance(batch, (tuple, list)) else batch
        take = min(imgs.shape[0], max_samples - seen)
        feats = extract_fn(imgs)[:take]
        seen += take
        yield feats


def compute_fid(real_batches, fake_batches, extract_fn,
                num_samples: int = 50_000, verbose: bool = False) -> float:
    '''FID between two image streams (NCHW in [-1, 1]).

    `extract_fn(images) -> [B, D]` runs on the device (see
    `inception.make_extractor`).
    '''
    accs = []
    for name, stream in (('real', real_batches), ('fake', fake_batches)):
        acc = None
        for feats in _feature_stream(stream, extract_fn, num_samples):
            if acc is None:
                acc = FeatureAccumulator(feats.shape[1])
            acc.update(feats)
            if verbose and acc.n % 10_000 < feats.shape[0]:
                print(f'[fid] {name}: {acc.n}/{num_samples}')
        if acc is None or acc.n < 2:
            raise ValueError(f'no {name} samples supplied')
        accs.append(acc.statistics())
    (mu_r, s_r), (mu_f, s_f) = accs
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def _poly_kernel(x, y, degree=3, gamma=None, coef0=1.0):
    d = x.shape[1]
    gamma = gamma if gamma is not None else 1.0 / d
    return (x @ y.T * gamma + coef0) ** degree


def compute_kid(real_feats, fake_feats, num_subsets: int = 100,
                subset_size: int = 1000, seed: int = 0) -> float:
    '''Kernel Inception Distance (MMD^2, cubic kernel; StyleGAN2-ADA
    metrics/kernel_inception_distance.py protocol). The kernel products run
    in float64 on the device of `real_feats`; the subsets come from numpy.'''
    rng = np.random.default_rng(seed)
    x = _f64(real_feats)
    y = _f64(fake_feats, x.device)
    n = min(subset_size, x.shape[0], y.shape[0])
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for _ in range(num_subsets):
        xi = x[torch.from_numpy(rng.choice(x.shape[0], n, replace=False)).to(x.device)]
        yi = y[torch.from_numpy(rng.choice(y.shape[0], n, replace=False)).to(x.device)]
        kxx = _poly_kernel(xi, xi)
        kyy = _poly_kernel(yi, yi)
        kxy = _poly_kernel(xi, yi)
        a = (kxx.sum() - torch.trace(kxx)) / (n * (n - 1))
        b = (kyy.sum() - torch.trace(kyy)) / (n * (n - 1))
        c = kxy.mean()
        total += a + b - 2 * c
    return float(total / num_subsets)
