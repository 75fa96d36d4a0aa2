'''The activation lookup of the JAX package's layer helpers, in PyTorch.

Counterpart of `get_activation` in `animeface_tpu/nnutils/module/layers.py`
(`:14-33`), with JAX's functions where PyTorch's defaults differ:
  * 'lrelu'/'leakyrelu' is the port's leaky ReLU at 0.2
    (`ops/activations.py:leaky_relu`: `jax.nn.leaky_relu`'s gradient, 1 at
    exactly 0);
  * 'gelu' is the tanh approximation (`jax.nn.gelu` defaults to
    approximate=True, `F.gelu` to the exact form);
  * 'prelu' is a module with one parameter, `negative_slope`, initialised to
    0.01, as flax's `nn.PReLU`.
The rest of `layers.py` comes with its first user.
'''

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

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
