'''Training helpers (counterpart of `animeface_tpu/nnutils/training.py`).'''

from __future__ import annotations

import contextlib

import torch
from torch import nn


@torch.no_grad()
def update_ema(model: nn.Module, ema_model: nn.Module, decay: float = 0.999,
               buffers: bool = False) -> None:
    '''ema = decay * ema + (1 - decay) * params, IN PLACE on `ema_model`'s
    parameters, under `torch.no_grad()` (JAX returned a new pytree).
    `decay=0` copies the parameters. With `buffers`, the floating-point
    buffers (spectral norm's u, running statistics) move the same way, as
    JAX's `update_ema` over {'params', 'batch_stats'} (SEBigGAN) does.'''
    pairs = list(zip(ema_model.parameters(), model.parameters()))
    if buffers:
        pairs += [(e, b) for e, b in zip(ema_model.buffers(), model.buffers())
                  if e.is_floating_point()]
    for e, p in pairs:
        e.mul_(decay).add_(p.to(e.dtype), alpha=1.0 - decay)


@contextlib.contextmanager
def buffers_dropped(*modules):
    '''Run the block, then put `modules`' buffers (running statistics,
    spectral norm's u) back as they were before it: its updates are
    dropped, as JAX discards a phase's `mutable` output.'''
    buffers = [b for m in modules for b in m.buffers()]
    kept = [b.clone() for b in buffers]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in zip(buffers, kept):
                b.copy_(v)


def step_all_parameters(opt: torch.optim.Optimizer, module: nn.Module) -> None:
    '''Optimizer step in which a parameter outside the loss's graph gets a
    zero gradient (as optax steps every leaf), so Adam's moments and step
    count advance for every parameter every iteration.'''
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    opt.step()


def train_state(run) -> dict:
    '''The training state of a `build_training` namespace, as `run_training`
    and the checkpoints take it: the modules, the optimizers and the step's
    own dict (step count, generator, controller) under 'run'. A recipe
    without an EMA copy of G has no 'G_ema'.'''
    state = dict(G=run.G, D=run.D, G_ema=getattr(run, 'G_ema', None), g_opt=run.g_opt,
                 d_opt=run.d_opt, run=run.state)
    return {k: v for k, v in state.items() if v is not None}
