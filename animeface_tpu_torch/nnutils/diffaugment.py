'''DiffAugment, differentiable augmentation for data-efficient GAN training
(Zhao et al. 2020, arXiv:2006.10738), in NCHW.

Counterpart of `animeface_tpu/nnutils/diffaugment.py`. The random draws are
inputs: `diff_augment(x, policy, draws)` takes one draw per function of the
expanded policy, in `AUGMENT_FNS` order, and `draw_diff_augment` makes them
from an explicit `torch.Generator`. A draw holds what JAX draws from its
key: the raw uniform in [0, 1) of shape [N, 1, 1, 1] in x's dtype for the
color functions, the integer offsets (th, tw) in [-shift, shift] for
translation and the hole centres (oh, ow) in [0, H + 1 - ch % 2) for
cutout, each of shape [N]. Every function is differentiable with respect
to x; translation is a gather over a zero-padded image and cutout a mask
product, so both are exact.
'''

from __future__ import annotations

import torch
import torch.nn.functional as F

TRANSLATION_RATIO = 0.125
CUTOUT_RATIO = 0.5


def rand_brightness(x, u):
    return x + (u - 0.5)


def rand_saturation(x, u):
    x_mean = x.mean(dim=1, keepdim=True)
    return (x - x_mean) * (u * 2) + x_mean


def rand_contrast(x, u):
    x_mean = x.mean(dim=(1, 2, 3), keepdim=True)
    return (x - x_mean) * (u + 0.5) + x_mean


def _shift(size, ratio):
    return int(size * ratio + 0.5)


def rand_translation(x, offsets, ratio: float = TRANSLATION_RATIO):
    '''out[n, :, i, j] = x[n, :, i + th[n], j + tw[n]], zero out of range.'''
    N, C, H, W = x.shape
    sh, sw = _shift(H, ratio), _shift(W, ratio)
    th, tw = offsets
    rows = torch.arange(H, device=x.device) + (sh + th)[:, None]         # [N, H]
    cols = torch.arange(W, device=x.device) + (sw + tw)[:, None]         # [N, W]
    x = F.pad(x, (sw, sw, sh, sh))
    x = x.gather(2, rows[:, None, :, None].expand(N, C, H, W + 2 * sw))
    return x.gather(3, cols[:, None, None, :].expand(N, C, H, W))


def rand_cutout(x, centres, ratio: float = CUTOUT_RATIO):
    '''Zero a ch x cw hole centred at (oh, ow), clamped into the image (a
    hole that crosses the border shrinks).'''
    N, C, H, W = x.shape
    ch, cw = _shift(H, ratio), _shift(W, ratio)
    oh, ow = centres

    def inside(o, c, size):
        start = (o - c // 2).clamp(0, size - 1)[:, None]
        end = (o - c // 2 + c - 1).clamp(0, size - 1)[:, None]
        g = torch.arange(size, device=x.device)
        return (g >= start) & (g <= end)                                # [N, size]

    mask = inside(oh, ch, H)[:, :, None] & inside(ow, cw, W)[:, None, :]
    return x * (1.0 - mask[:, None].to(x.dtype))


AUGMENT_FNS = {
    'color': [rand_brightness, rand_saturation, rand_contrast],
    'translation': [rand_translation],
    'cutout': [rand_cutout],
}


def policy_fns(policy: str):
    '''The functions of a policy string, e.g. 'color,translation', in order.'''
    return [f for p in policy.split(',') for f in AUGMENT_FNS[p]] if policy else []


def draw_diff_augment(n, h, w, policy, generator: torch.Generator, dtype=torch.float32):
    '''The draws of `diff_augment` for n images of h x w, from `generator`
    (on its device); the uniforms in `dtype`, which is the images' dtype.'''
    device = generator.device

    def randint(low, high):
        return torch.randint(low, high, (n,), generator=generator, device=device)

    draws = []
    for f in policy_fns(policy):
        if f is rand_translation:
            sh, sw = _shift(h, TRANSLATION_RATIO), _shift(w, TRANSLATION_RATIO)
            draws.append((randint(-sh, sh + 1), randint(-sw, sw + 1)))
        elif f is rand_cutout:
            ch, cw = _shift(h, CUTOUT_RATIO), _shift(w, CUTOUT_RATIO)
            draws.append((randint(0, h + 1 - ch % 2), randint(0, w + 1 - cw % 2)))
        else:
            draws.append(torch.rand((n, 1, 1, 1), generator=generator, dtype=dtype,
                                    device=device))
    return draws


def diff_augment(x, policy: str, draws):
    '''Apply the policy string to x [N, C, H, W] with `draws` (one per
    function, as `draw_diff_augment` makes them); '' returns x.'''
    fns = policy_fns(policy)
    if len(draws) != len(fns):
        raise ValueError(f'policy {policy!r} takes {len(fns)} draws, got {len(draws)}')
    for f, d in zip(fns, draws):
        x = f(x, d)
    return x

