'''In-box quality TREND metric: Frechet distance on fixed-seed random-VGG
features.

Counterpart of `animeface_tpu/metrics/trend.py`. The BASELINE's FID-50k
gate needs the pytorch-fid InceptionV3 weights, which are not in the
repository (ARTIFACTS_NEEDED.md), and a random-init Inception collapses
every input to near-constant features. A fixed-seed random VGG16 trunk (no
normalization layers) does not, so the Frechet distance over its
block-pooled activations is a deterministic RELATIVE quality signal: not
comparable with published FID numbers, but it moves toward the data as a
run converges, which is what a soak's gate needs.

Protocol: per block of `VGGFeatures(16)` with the fallback weights of
`nnutils/loss/vgg.py` (seed 20260816; drawn with torch's generator, so the
numbers are the port's own and comparable only within the port), the
per-channel spatial MEAN is pooled; the 5 pooled vectors concatenate to a
1472-d feature; the distance uses the float64 streaming statistics and
PSD-sqrt Frechet solve of `fid.py`.
'''

from __future__ import annotations

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.metrics.fid import FeatureAccumulator, frechet_distance

FEATURE_DIM = 64 + 128 + 256 + 512 + 512


def make_trend_extractor(variables=None, device=None):
    '''Returns `extract(images NCHW in [-1,1]) -> [B, 1472]`, the block
    means of VGG16 (f32, on `device`, default `cuda`). `variables` is a
    `VGGFeatures(16)` state dict; the default is the fixed-seed fallback.'''
    from animeface_tpu_torch.nnutils.loss.vgg import (
        frozen_vgg, normalize_imagenet, random_vgg_state)

    device = resolve_device(device)
    model = frozen_vgg(16, random_vgg_state(16) if variables is None else variables, device)

    @torch.no_grad()
    def extract(images):
        x = torch.as_tensor(images).to(device, torch.float32) * 0.5 + 0.5
        feats = model(normalize_imagenet(x, device))
        return torch.cat([f.mean(dim=(2, 3)) for f in feats], dim=-1)

    return extract


def trend_statistics(batches, extract=None, max_samples: int = 4096):
    '''(mu, cov) float64 statistics of an image-batch stream.'''
    extract = extract or make_trend_extractor()
    acc = FeatureAccumulator(FEATURE_DIM)
    for batch in batches:
        imgs = batch[0] if isinstance(batch, (tuple, list)) else batch
        take = min(imgs.shape[0], max_samples - acc.n)
        acc.update(extract(imgs)[:take])
        if acc.n >= max_samples:
            break
    return acc.statistics()


def trend_fd(stats_a, stats_b) -> float:
    '''Frechet distance between two `trend_statistics` results.'''
    (mu1, s1), (mu2, s2) = stats_a, stats_b
    return frechet_distance(mu1, s1, mu2, s2)
