'''flax's `nn.SpectralNorm` around a conv or a dense layer, in PyTorch.

Counterpart of the `SNConv`/`SNDense` wrappers of the JAX recipes (FastGAN,
BigGAN, SEBigGAN), which wrap flax's `nn.Conv`/`nn.Dense` in
`nn.SpectralNorm`. Not torch's parametrization. Kept from flax:
  * every call runs one power iteration from the stored `u` (a buffer of
    [out]) on the weight as an [out, fan_in] matrix, with l2-normalisation
    x * rsqrt(sum(x^2) + 1e-12), and divides the weight by sigma = u' . (W v),
    u' and v held constant; `train=True` stores u' (flax's `update_stats`),
    eval mode iterates without storing;
  * the power iteration in float32; the layer computes in its `dtype`.
With `use_sn=False` the layer is the plain conv or dense layer (no `u`).
The weight starts from `weight_init(shape, generator)` on the torch layout
([out, in, kh, kw] or [out, in]), by default N(0, 1 / fan_in).
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _l2_normalize(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


def _lecun_normal(shape, generator):
    return torch.randn(shape, generator=generator) / math.sqrt(math.prod(shape[1:]))


class _SpectralNorm(nn.Module):
    '''A weight [out, ...] divided by its largest singular value, estimated
    by one power iteration from the buffer `u` on every call.'''

    def _init_sn(self, weight_shape, generator, use_sn=True, weight_init=None):
        self.weight = nn.Parameter((weight_init or _lecun_normal)(weight_shape, generator))
        self.use_sn = use_sn
        if use_sn:
            self.register_buffer('u', torch.randn(weight_shape[0], generator=generator))

    def normalized_weight(self, train: bool):
        w = self.weight
        if not self.use_sn:
            return w
        mat = w.reshape(w.shape[0], -1)                          # [out, fan_in]
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat)
            u = _l2_normalize(mat @ v)
        sigma = torch.dot(u, mat @ v)
        if train:
            with torch.no_grad():
                self.u.copy_(u)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SNConv(_SpectralNorm):
    '''Spectral-normalized conv; `padding` 'SAME' (odd kernels, stride 1),
    'VALID' or an int.'''

    def __init__(self, in_ch, features, kernel_size=3, stride=1, padding='SAME',
                 use_bias=True, dtype=torch.float32, generator=None, use_sn=True,
                 weight_init=None):
        super().__init__()
        self._init_sn((features, in_ch, kernel_size, kernel_size), generator, use_sn,
                      weight_init)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        if padding == 'SAME':
            assert stride == 1 and kernel_size % 2 == 1
            padding = kernel_size // 2
        self.padding = 0 if padding == 'VALID' else padding
        self.stride = stride
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        w = self.normalized_weight(train).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, self.padding)


class SNDense(_SpectralNorm):
    '''Spectral-normalized dense layer; weight [out, in].'''

    def __init__(self, in_features, features, use_bias=True, dtype=torch.float32,
                 generator=None, use_sn=True, weight_init=None):
        super().__init__()
        self._init_sn((features, in_features), generator, use_sn, weight_init)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        w = self.normalized_weight(train).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), w, b)
