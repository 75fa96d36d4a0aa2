'''bias_act — bias add, activation, gain and clamp, in plain PyTorch.

Counterpart of `animeface_tpu/ops/bias_act.py` (its `activation_funcs` table
and the 'xla' path of `bias_act`). The JAX package's opt-in Pallas kernel
(`bias_act_pallas`) is not ported here: the default configuration never
reaches it, and its port needs a second-order backward for R1.

The bias runs along axis 1: the NCHW channel axis, and the feature axis of
a [batch, features] input (the JAX package defaults to -1, its NHWC channel
axis).
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


_SQRT2 = float(np.sqrt(2))

activation_funcs = {
    'linear':   Activation(lambda x, **_: x, 0.0, 1.0),
    'relu':     Activation(lambda x, **_: F.relu(x), 0.0, _SQRT2),
    'lrelu':    Activation(lambda x, alpha, **_: F.leaky_relu(x, alpha), 0.2, _SQRT2),
    'tanh':     Activation(lambda x, **_: torch.tanh(x), 0.0, 1.0),
    'sigmoid':  Activation(lambda x, **_: torch.sigmoid(x), 0.0, 1.0),
    'elu':      Activation(lambda x, **_: F.elu(x), 0.0, 1.0),
    'selu':     Activation(lambda x, **_: F.selu(x), 0.0, 1.0),
    'softplus': Activation(lambda x, **_: F.softplus(x), 0.0, 1.0),
    'swish':    Activation(lambda x, **_: F.silu(x), 0.0, _SQRT2),
}


def bias_act(x, b=None, act: str = 'linear', alpha=None, gain=None, clamp=None):
    '''x + b (along axis 1), then the activation, times `gain`, clipped to
    [-clamp, clamp]. `alpha`, `gain` default to the activation's own.'''
    assert clamp is None or clamp >= 0
    spec = activation_funcs[act]
    alpha = float(alpha if alpha is not None else spec.def_alpha)
    gain = float(gain if gain is not None else spec.def_gain)
    if b is not None:
        assert b.ndim == 1 and b.shape[0] == x.shape[1]
        x = x + b.reshape([1, -1] + [1] * (x.ndim - 2)).to(x.dtype)
    x = spec.func(x, alpha=alpha)
    if gain != 1:
        x = x * gain
    if clamp is not None:
        x = x.clamp(-clamp, clamp)
    return x
