'''Gradient penalties (counterpart of `animeface_tpu/nnutils/loss/penalty.py`).

`d_apply` maps images to logits. The input gradient is taken with
`torch.autograd.grad(..., create_graph=True)`, so the outer backward
differentiates through it, and the input is taken in float32.
'''

from __future__ import annotations

from typing import Callable

import torch


def _input_gradients(d_apply: Callable, x):
    '''d/dx sum(D(x)) per sample, with the graph kept for the outer backward.'''
    x = x.detach().float().requires_grad_(True)
    out = d_apply(x).float().sum()
    (grad,) = torch.autograd.grad(out, x, create_graph=True)
    return grad


def r1_regularizer(real, d_apply: Callable):
    '''R1: E[ ||grad_x D(x)||^2 ] / 2 on real images.'''
    g = _input_gradients(d_apply, real).reshape(real.shape[0], -1)
    return (g * g).sum(dim=1).mean() / 2.0
