'''Training helpers (counterpart of `animeface_tpu/nnutils/training.py`).'''

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def update_ema(model: nn.Module, ema_model: nn.Module, decay: float = 0.999) -> None:
    '''ema = decay * ema + (1 - decay) * params, IN PLACE on `ema_model`'s
    parameters, under `torch.no_grad()` (JAX returned a new pytree).
    `decay=0` copies the parameters.'''
    for e, p in zip(ema_model.parameters(), model.parameters()):
        e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)


def step_all_parameters(opt: torch.optim.Optimizer, module: nn.Module) -> None:
    '''Optimizer step in which a parameter outside the loss's graph gets a
    zero gradient (as optax steps every leaf), so Adam's moments and step
    count advance for every parameter every iteration.'''
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()
