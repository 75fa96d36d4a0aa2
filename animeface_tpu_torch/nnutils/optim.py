'''optax's RMSprop as a `torch.optim.Optimizer`.

Counterpart of `optax.rmsprop(lr)` at its defaults, as the JAX WGAN recipe
uses it (`WGAN/utils.py:90-91`): decay 0.9, nu initialised to 0, eps 1e-8
INSIDE the square root, no momentum, not centered:
    nu <- (1 - decay) * g^2 + decay * nu
    p  <- p - lr * g * rsqrt(nu + eps)
`torch.optim.RMSprop` adds eps outside the root (and defaults to alpha
0.99), so no choice of its arguments gives this update; the two differ most
where g is near 0.
'''

from __future__ import annotations

import torch


#: optax.rmsprop's decay and eps
DECAY, EPS = 0.9, 1e-8


class RMSprop(torch.optim.Optimizer):
    '''optax.rmsprop(lr); state 'nu' per parameter.'''

    def __init__(self, params, lr: float):
        super().__init__(params, dict(lr=lr))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise NotImplementedError('closures are not supported')
        for group in self.param_groups:
            for p in group['params']:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state['nu'] = torch.zeros_like(p)
                nu = state['nu']
                nu.mul_(DECAY).add_(p.grad.square().mul_(1 - DECAY))
                p.sub_(p.grad * torch.rsqrt(nu + EPS) * group['lr'])
