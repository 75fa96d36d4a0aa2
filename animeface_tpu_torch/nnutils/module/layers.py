'''The activation and normalization lookups of the JAX package's layer
helpers, in PyTorch.

Counterpart of `get_activation` and `get_normalization` in
`animeface_tpu/nnutils/module/layers.py` (`:14-55`), with JAX's functions
where PyTorch's defaults differ:
  * 'lrelu'/'leakyrelu' is the port's leaky ReLU at 0.2
    (`ops/activations.py:leaky_relu`: `jax.nn.leaky_relu`'s gradient, 1 at
    exactly 0);
  * 'gelu' is the tanh approximation (`jax.nn.gelu` defaults to
    approximate=True, `F.gelu` to the exact form);
  * 'prelu' is a module with one parameter, `negative_slope`, initialised to
    0.01, as flax's `nn.PReLU`;
  * the norms are flax's over NCHW (`linen.py`, `batchnorm.py`): 'in' a
    GroupNorm of one channel a group without scale or bias, eps 1e-5
    (torch's `InstanceNorm2d` defaults, which the JAX function keeps); 'bn'
    flax's BatchNorm, momentum 0.9, eps 1e-5, on batch statistics (the JAX
    function builds it with `use_running_average=False`); 'ln' flax's
    LayerNorm over the channels of each pixel, eps 1e-6; 'gn' flax's
    GroupNorm, 32 groups (flax's default), eps 1e-6.
The rest of `layers.py` comes with its first user.
'''

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.module.linen import GroupNorm, LayerNorm
from animeface_tpu_torch.ops.activations import leaky_relu


class PReLU(nn.Module):
    '''flax `nn.PReLU`: where(x >= 0, x, a * x), one scalar `a` from 0.01.'''

    def __init__(self, negative_slope_init: float = 0.01):
        super().__init__()
        self.negative_slope = nn.Parameter(torch.tensor(negative_slope_init))

    def forward(self, x):
        return torch.where(x >= 0, x, self.negative_slope.to(x.dtype) * x)


def get_activation(name: str, inplace: bool = True) -> Callable:
    '''Name -> activation callable (a module for 'prelu'). `inplace` is
    accepted for the reference's signature and ignored.'''
    if name == 'relu':
        return F.relu
    if name in ('lrelu', 'leakyrelu'):
        return lambda x: leaky_relu(x, 0.2)
    if name == 'tanh':
        return torch.tanh
    if name == 'gelu':
        return lambda x: F.gelu(x, approximate='tanh')
    if name in ('swish', 'silu'):
        return F.silu
    if name == 'prelu':
        return PReLU()
    if name == 'sigmoid':
        return torch.sigmoid
    raise Exception(f'activation: {name}')


def get_normalization(name: str, channels: int, dtype=torch.float32) -> nn.Module:
    '''Name -> norm module over NCHW feature maps of `channels` (module
    docstring).'''
    if name == 'in':
        return GroupNorm(channels, channels, 1e-5, affine=False, dtype=dtype)
    if name == 'bn':
        return BatchNorm(channels, dtype=dtype)
    if name == 'ln':
        return LayerNorm(channels, dtype=dtype, dim=1)
    if name == 'gn':
        return GroupNorm(channels, 32, dtype=dtype)
    raise Exception(f'normalization: {name}')
