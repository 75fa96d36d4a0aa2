'''Gradient penalties (counterpart of `animeface_tpu/nnutils/loss/penalty.py`).

`d_apply` maps images to logits. The input gradient is taken with
`torch.autograd.grad(..., create_graph=True)`, so the outer backward
differentiates through it, and the input is taken in float32. Random draws
are inputs: `gradient_penalty` takes its alpha.
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


def _norm_penalty(gradients, center: float):
    g = gradients.reshape(gradients.shape[0], -1)
    norm = torch.sqrt((g * g).sum(dim=1) + 1e-12)
    return ((norm - center) ** 2).mean()


def gradient_penalty(real, fake, d_apply: Callable, alpha, center: float = 1.0):
    '''WGAN-gp's penalty at one real/fake interpolate: mean((||grad_x
    D(x_hat)|| - center)^2), x_hat = real * alpha + fake * (1 - alpha) in
    float32, with ONE alpha for the whole batch ([1, 1, 1, 1], U[0, 1), a
    draw), as the JAX package's and the reference's `torch.rand(1)`.
    (`WGAN_gp/utils.py:per_sample_gradient_penalty` draws one per sample.)'''
    if center not in (0.0, 1.0):
        raise ValueError(f'center must be 0 or 1, got {center}')
    x_hat = real.float() * alpha + fake.float() * (1.0 - alpha)
    return _norm_penalty(_input_gradients(d_apply, x_hat), center)


def r1_regularizer(real, d_apply: Callable):
    '''R1: E[ ||grad_x D(x)||^2 ] / 2 on real images.'''
    g = _input_gradients(d_apply, real).reshape(real.shape[0], -1)
    return (g * g).sum(dim=1).mean() / 2.0
