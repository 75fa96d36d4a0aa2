'''optax's RMSprop as a `torch.optim.Optimizer`, and optax's learning-rate
schedules on the port's optimizers.

Counterpart of `optax.rmsprop(lr)` at its defaults, as the JAX WGAN recipe
uses it (`WGAN/utils.py:90-91`): decay 0.9, nu initialised to 0, eps 1e-8
INSIDE the square root, no momentum, not centered:
    nu <- (1 - decay) * g^2 + decay * nu
    p  <- p - lr * g * rsqrt(nu + eps)
`torch.optim.RMSprop` adds eps outside the root (and defaults to alpha
0.99), so no choice of its arguments gives this update; the two differ most
where g is near 0.

A schedule is `schedule(count) -> lr`, `count` the updates made before
this one, as optax's `scale_by_schedule` reads its own count.
`constant_then_linear` is `optax.join_schedules([constant_schedule(lr),
linear_schedule(lr, end, transition)], [boundary])` (CycleGAN);
`scheduled(step, optimizers, schedule)` sets each optimizer's lr from the
step's count (`state['step']`: every optimizer of the step updates once a
step, so a resumed run goes on from its checkpoint's count) before each
step.
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


def constant_then_linear(lr: float, boundary: int, end: float, transition: int):
    '''`lr` for the first `boundary` updates, then linear to `end` over
    `transition` updates, then `end` (`transition` <= 0: `lr` throughout,
    as optax's linear schedule).'''
    def schedule(count: int) -> float:
        if count < boundary or transition <= 0:
            return lr
        done = min(count - boundary, transition)
        return (lr - end) * (1 - done / transition) + end
    return schedule


def scheduled(step, optimizers, schedule):
    '''`step(state, batch, draws=None)` with each of `optimizers`' learning
    rate set to `schedule(state['step'])` first.'''
    def train_step(state, batch, draws=None):
        lr = schedule(int(state['step']))
        for opt in optimizers:
            for group in opt.param_groups:
                group['lr'] = lr
        return step(state, batch, draws)
    return train_step
