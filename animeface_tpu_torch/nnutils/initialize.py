'''Weight-init registry, in PyTorch.

Counterpart of `animeface_tpu/nnutils/initialize.py`: `get_initializer(name)`,
`apply_init(module, name, generator, names)` (which redraws the parameters
of a built module with a scheme, as the JAX function redraws a params
pytree) and the `init` facade. The schemes keep flax's semantics, not
`torch.nn.init`'s:
  * `xavier` is flax `xavier_normal` and `kaiming` is `kaiming_normal`
    (He: scale 2, fan_in), both `variance_scaling(..., 'truncated_normal')`:
    a normal of std sigma / 0.87962566 cut at +-2 of that std, sigma**2 =
    scale / fan, so the kept draws have std sigma;
  * `ortho` is flax `orthogonal()` on the kernel read as a [fan_in, out]
    matrix (orthonormal columns, or rows when fan_in < out); on a torch
    weight [out, in, ...] that matrix is `w.reshape(out, -1).T`;
  * `N01`, `N002`, `zeros` and `ones` are plain.
An initializer is `init(shape, generator) -> tensor` on the torch layout
([out, in, kh, kw] for a conv, [out, in] for a dense layer), whose fans are
flax's: fan_in = in * receptive field, fan_out = out * receptive field.
The draws come from `generator` and cannot match JAX's threefry; the rules
and the distributions are what carry over.
'''

from __future__ import annotations

import math

import torch
from torch import nn

#: std of N(0, 1) truncated to [-2, 2] (flax's variance_scaling constant)
_TRUNC_STD = 0.87962566103423978


def _fans(shape):
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def _truncated_normal(shape, generator=None):
    '''N(0, 1) cut at +-2: the draws outside drawn again, in index order,
    until none is (only the redrawn entries are checked again).'''
    w = torch.randn(shape, generator=generator)
    flat = w.view(-1)
    idx = (flat.abs() > 2).nonzero().squeeze(1)
    while idx.numel():
        flat[idx] = torch.randn(idx.numel(), generator=generator)
        idx = idx[flat[idx].abs() > 2]
    return w


def _variance_scaling(scale, mode):
    def init(shape, generator=None):
        fan_in, fan_out = _fans(shape)
        fan = fan_in if mode == 'fan_in' else (fan_in + fan_out) / 2
        return _truncated_normal(shape, generator) * (math.sqrt(scale / fan) / _TRUNC_STD)
    return init


def _normal(std):
    def init(shape, generator=None):
        return torch.randn(shape, generator=generator) * std
    return init


def _orthogonal(shape, generator=None):
    fan_in, out = math.prod(shape[1:]), shape[0]
    a = torch.randn((max(fan_in, out), min(fan_in, out)), generator=generator)
    q, r = torch.linalg.qr(a)
    q = q * torch.sign(torch.diagonal(r))
    m = q if fan_in >= out else q.T                       # [fan_in, out]
    return m.T.reshape(shape).contiguous()


_REGISTRY = {
    'N01':     _normal(1.0),
    'N002':    _normal(0.02),
    'ortho':   _orthogonal,
    'xavier':  _variance_scaling(1.0, 'fan_avg'),
    'kaiming': _variance_scaling(2.0, 'fan_in'),
    'zeros':   lambda shape, generator=None: torch.zeros(shape),
    'ones':    lambda shape, generator=None: torch.ones(shape),
}


def get_initializer(name: str):
    if name not in _REGISTRY:
        raise KeyError(f'unknown initializer {name!r}; have {sorted(_REGISTRY)}')
    return _REGISTRY[name]


@torch.no_grad()
def apply_init(module: nn.Module, name: str = 'N002', generator: torch.Generator = None,
               names: tuple = ()) -> nn.Module:
    '''Redraw `module`'s parameters in place with the named scheme; returns it.

    A parameter named `weight` (or a name in `names`) with ndim >= 2 gets the
    scheme; every `bias` gets zeros; a 1-D `weight` (a norm's scale, flax's
    `scale`) gets ones; everything else (attention's `gamma`, `pos_emb`, a
    PReLU's slope) and every buffer (spectral norm's `u`, running
    statistics: flax's `batch_stats`) is left as it is.'''
    initializer = get_initializer(name)
    for path, p in module.named_parameters():
        last = path.rsplit('.', 1)[-1]
        if last in ('weight', *names) and p.ndim >= 2:
            p.copy_(initializer(tuple(p.shape), generator))
        elif last == 'bias':
            p.zero_()
        elif last == 'weight' and p.ndim == 1:
            p.fill_(1.)
    return module


class init:
    '''Reference-shaped facade: `init().N01` etc. return
    (module, generator) -> module.'''

    def __init__(self, my_classes=None, names=None) -> None:
        self.names = tuple(names) if names else ()

    def _make(self, scheme):
        def apply(module, generator=None):
            return apply_init(module, scheme, generator, self.names)
        return apply

    @property
    def N01(self):
        return self._make('N01')

    @property
    def N002(self):
        return self._make('N002')

    @property
    def xavier(self):
        return self._make('xavier')

    @property
    def kaiming(self):
        return self._make('kaiming')
