'''flax's `nn.BatchNorm` in PyTorch.

Counterpart of `flax.linen.BatchNorm` as the JAX recipes configure it
(FastGAN's `Norm` 'bn', DCGAN's layers, GAN's `BatchNorm1d` with eps 0.8).
`torch.nn.BatchNorm*` keeps the unbiased running variance at momentum 0.1,
so it is not a substitute. Kept from flax:
  * the batch statistics in float32 over every axis but the feature axis
    (1: [B, F] and NCHW inputs), the variance as E[x^2] - E[x]^2 clipped
    at 0;
  * the running mean and the BIASED running variance, updated as
    momentum * running + (1 - momentum) * batch (momentum 0.9), used when
    `train=False`;
  * y = (x - mean) * (rsqrt(var + eps) * scale) + bias in float32, cast to
    the compute `dtype`; without a scale or a bias (`use_scale=False`,
    `use_bias=False`, as BigGAN's conditional norm) those terms drop out.
`instance_norm` is flax's `nn.GroupNorm` with one channel per group and
neither scale nor bias (FastGAN's and BigGAN's 'in').
Every step of the normalization is a differentiable PyTorch op, so a double
backward (WGAN-gp's penalty) is autograd's; the running statistics are
updated outside the graph.
'''

from __future__ import annotations

import torch
from torch import nn

#: flax's default, which every JAX recipe keeps
MOMENTUM = 0.9


def batch_norm(x, weight, bias, running_mean, running_var, train: bool, eps: float = 1e-5,
               dtype=torch.float32):
    '''flax's batch normalization of `x` ([B, F] or [B, C, ...]) over every
    axis but 1. With `train`, normalize by the batch statistics and move the
    running ones towards them in place; else normalize by the running ones.
    `weight` (the scale) and `bias` may be None.'''
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    axes = [d for d in range(x.ndim) if d != 1]
    if train:
        mean = xf.mean(dim=axes)
        var = ((xf * xf).mean(dim=axes) - mean * mean).clamp_min(0)
        with torch.no_grad():
            running_mean.mul_(MOMENTUM).add_(mean.detach(), alpha=1 - MOMENTUM)
            running_var.mul_(MOMENTUM).add_(var.detach(), alpha=1 - MOMENTUM)
    else:
        mean, var = running_mean, running_var
    shape = (1, -1) + (1,) * (x.ndim - 2)
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight
    y = (xf - mean.reshape(shape)) * mul.reshape(shape)
    if bias is not None:
        y = y + bias.reshape(shape)
    return y.to(dtype)


def instance_norm(x, eps: float = 1e-6, dtype=torch.float32):
    '''flax `nn.GroupNorm(num_groups=C)` without scale or bias over NCHW `x`:
    each sample's channel normalized by its own mean and E[x^2] - E[x]^2
    over H and W, in float32, cast to `dtype`.'''
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mean = xf.mean(dim=(2, 3))
    var = ((xf * xf).mean(dim=(2, 3)) - mean * mean).clamp_min(0)
    y = (xf - mean[..., None, None]) * torch.rsqrt(var + eps)[..., None, None]
    return y.to(dtype)


class BatchNorm(nn.Module):
    '''flax `nn.BatchNorm(momentum=0.9)` over the features of axis 1, with a
    scale (`weight`) and a `bias`; `scale_init(shape)` gives the initial
    scale (ones by default). With `affine=False` (flax's `use_scale=False,
    use_bias=False`) it has neither.'''

    def __init__(self, features, eps: float = 1e-5, dtype=torch.float32, scale_init=None,
                 affine: bool = True):
        super().__init__()
        self.weight = self.bias = None
        if affine:
            self.weight = nn.Parameter(torch.ones(features) if scale_init is None
                                       else scale_init((features,)))
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer('running_mean', torch.zeros(features))
        self.register_buffer('running_var', torch.ones(features))
        self.eps, self.dtype = eps, dtype

    def forward(self, x, train: bool = True):
        return batch_norm(x, self.weight, self.bias, self.running_mean, self.running_var,
                          train, self.eps, self.dtype)
