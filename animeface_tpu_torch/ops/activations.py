'''The activation table of `bias_act`.

Counterpart of `activation_funcs` in `animeface_tpu/ops/bias_act.py`: each
activation's function, its default alpha and its default gain. The
composition (`ops/bias_act.py`) and the kernel's plain version
(`ops/cuda_kernels.py`) both read it. `leaky_relu` is the port's leaky
ReLU: `jax.nn.leaky_relu` is `where(x >= 0, x, alpha * x)`, whose gradient
at exactly 0 is 1 where `F.leaky_relu`'s is alpha, and zero-filled
augmented pixels through a zero bias land exactly there.
'''

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Activation(NamedTuple):
    func: Callable
    def_alpha: float
    def_gain: float


class _LeakyReLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x)
        ctx.alpha = alpha
        return F.leaky_relu(x, alpha)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        # differentiable in g, so a double backward (R1) runs through it
        return torch.where(x >= 0, g, g * ctx.alpha), None


def leaky_relu(x, alpha: float = 0.2):
    '''`F.leaky_relu`'s values with `jax.nn.leaky_relu`'s gradient (1 at 0).'''
    return _LeakyReLU.apply(x, alpha)


_SQRT2 = float(np.sqrt(2))

activation_funcs = {
    'linear':   Activation(lambda x, **_: x, 0.0, 1.0),
    'relu':     Activation(lambda x, **_: F.relu(x), 0.0, _SQRT2),
    'lrelu':    Activation(lambda x, alpha, **_: leaky_relu(x, alpha), 0.2, _SQRT2),
    'tanh':     Activation(lambda x, **_: torch.tanh(x), 0.0, 1.0),
    'sigmoid':  Activation(lambda x, **_: torch.sigmoid(x), 0.0, 1.0),
    'elu':      Activation(lambda x, **_: F.elu(x), 0.0, 1.0),
    'selu':     Activation(lambda x, **_: F.selu(x), 0.0, 1.0),
    'softplus': Activation(lambda x, **_: F.softplus(x), 0.0, 1.0),
    'swish':    Activation(lambda x, **_: F.silu(x), 0.0, _SQRT2),
}
