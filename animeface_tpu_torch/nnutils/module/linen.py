'''flax.linen's Dense, Conv, ConvTranspose, LayerNorm, GroupNorm and Dropout
in PyTorch.

The layers of the simple-GAN models (TransGAN, HiT, ConvNeXt, VAN) and of
pix2pix keep flax's semantics where PyTorch's defaults differ:
  * an explicit compute `dtype`: Dense and Conv cast the input, the weight
    and the bias to it, as flax's `dtype` does (the parameters stay float32);
  * kernels from flax's default `lecun_normal` (truncated normal, variance
    1 / fan_in) unless an initializer is given (`init(shape, generator)` on
    the torch layout, `nnutils/initialize.py`), biases at 0;
  * ConvTranspose: flax's `nn.ConvTranspose` does not flip its kernel
    and PyTorch's `conv_transpose2d` does, so the weight is the flax
    kernel flipped in H and W, laid out [in, out, kh, kw]
    (`convert.py:_conv_transpose`); flax's 'SAME' pads the dilated input by
    ceil((k + s - 2) / 2) before and the rest after (k - 1 and s - 1 when
    s > k - 1), which is PyTorch's `padding` k - 1 - that when both sides
    are equal (4x4 at stride 2 is padding 1); where they differ (3x3 at
    stride 2 pads 2 before and 1 after) the transposed conv runs at the
    smaller side's padding and the output is cropped on the other side
    (the first 2H x 2W of padding 0 for 3x3 at stride 2);
  * LayerNorm and GroupNorm: epsilon 1e-6 (PyTorch's default is 1e-5),
    statistics in float32 as E[x^2] - E[x]^2 clipped at 0 (flax's fast
    variance), y = (x - mean) * (rsqrt(var + eps) * scale) + bias in
    float32, cast to `dtype`; LayerNorm over the last axis, or over the
    channels of each pixel of NCHW with `dim=1` (flax's LayerNorm on NHWC);
    GroupNorm over NCHW, its groups over channels and all of H and W;
  * `f32(x)` is flax's `astype(float32)` for the float32 islands (attention
    logits, float32 heads): bf16 and f32 become f32, a float64 run stays
    float64;
  * `dropout(x, rate, source)` is flax's `nn.Dropout`: without a source
    (flax without a 'dropout' rng, torch's eval mode) or at rate 0 it
    returns x; else it keeps each element with 1 - rate and scales the
    kept ones by 1 / (1 - rate). The source is a `torch.Generator` on x's
    device or a callable `(shape, keep) -> bool mask`, which replays given
    masks.
'''

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import instance_norm
from animeface_tpu_torch.nnutils.initialize import _variance_scaling

#: flax's default kernel init, `lecun_normal`
lecun_normal = _variance_scaling(1.0, 'fan_in')


def f32(x):
    '''x in float32, or in float64 if it is (module docstring).'''
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _param(shape, init, generator):
    return nn.Parameter((init or lecun_normal)(tuple(shape), generator))


class Dense(nn.Module):
    '''flax `nn.Dense` on the last axis; weight [out, in].'''

    def __init__(self, in_features, features, use_bias=True, dtype=torch.float32, init=None,
                 generator=None):
        super().__init__()
        self.weight = _param((features, in_features), init, generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), self.weight.to(self.dtype), b)


class Conv(nn.Module):
    '''flax `nn.Conv` over NCHW; weight [out, in / groups, kh, kw]; an int
    `padding` pads each side, as flax's int padding does ('SAME' for an odd
    kernel at stride 1 is kernel // 2).'''

    def __init__(self, in_ch, features, kernel_size, stride=1, padding=0, dilation=1,
                 groups=1, use_bias=True, dtype=torch.float32, init=None, generator=None):
        super().__init__()
        self.weight = _param((features, in_ch // groups, kernel_size, kernel_size), init,
                             generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.stride, self.padding, self.dilation, self.groups = stride, padding, dilation, groups
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), b, self.stride,
                        self.padding, self.dilation, self.groups)


class ConvTranspose(nn.Module):
    '''flax `nn.ConvTranspose(features, (k, k), strides=(s, s),
    padding='SAME')` over NCHW; weight [in, out, k, k] (module docstring).'''

    def __init__(self, in_ch, features, kernel_size, stride=1, use_bias=True,
                 dtype=torch.float32, init=None, generator=None):
        super().__init__()
        pad_len = kernel_size + stride - 2          # flax's SAME: before, then after
        before = kernel_size - 1 if stride > kernel_size - 1 else -(-pad_len // 2)
        # PyTorch's padding on each side: the output loses that many rows
        lose_before, lose_after = kernel_size - 1 - before, kernel_size - 1 - (pad_len - before)
        if min(lose_before, lose_after) < 0:
            raise ValueError(f'flax SAME pads a {kernel_size}x{kernel_size} transposed conv at '
                             f'stride {stride} unevenly, past its kernel, which neither '
                             'conv_transpose2d nor a crop of it gives')
        # flax's fans are those of [out, in, k, k]: drawn there, then laid out
        self.weight = nn.Parameter(_param((features, in_ch, kernel_size, kernel_size), init,
                                          generator).detach().transpose(0, 1).contiguous())
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.stride = stride
        self.padding = min(lose_before, lose_after)
        # the rows still to crop (before, after) past the symmetric padding
        self.crop = (lose_before - self.padding, lose_after - self.padding)
        self.dtype = dtype

    def forward(self, x):
        b = None if self.bias is None else self.bias.to(self.dtype)
        y = F.conv_transpose2d(x.to(self.dtype), self.weight.to(self.dtype), b, self.stride,
                               self.padding)
        if self.crop != (0, 0):
            before, after = self.crop
            y = y[..., before:y.shape[-2] - after, before:y.shape[-1] - after]
        return y


def _normalize(xf, mean, var, weight, bias, eps, shape):
    mul = torch.rsqrt(var + eps)
    if weight is not None:
        mul = mul * weight.reshape(shape)
    y = (xf - mean) * mul
    if bias is not None:
        y = y + bias.reshape(shape)
    return y


def _stats(xf, dims):
    mean = xf.mean(dim=dims, keepdim=True)
    var = ((xf * xf).mean(dim=dims, keepdim=True) - mean * mean).clamp_min(0)
    return mean, var


def layer_norm(x, weight, bias, eps=1e-6, dtype=torch.float32, dim=-1):
    '''flax `nn.LayerNorm` over the last axis, or over axis 1 of NCHW.'''
    xf = f32(x)
    mean, var = _stats(xf, (dim,))
    shape = (-1,) if dim == -1 else (1, -1) + (1,) * (x.ndim - 2)
    return _normalize(xf, mean, var, weight, bias, eps, shape).to(dtype)


def group_norm(x, num_groups, weight, bias, eps=1e-6, dtype=torch.float32):
    '''flax `nn.GroupNorm(num_groups)` over NCHW `x`; one channel a group
    without scale or bias is `instance_norm`.'''
    N, C = x.shape[:2]
    if num_groups == C and weight is None and bias is None and x.ndim == 4:
        return instance_norm(x, eps, dtype)
    xf = f32(x)
    mean, var = _stats(xf.reshape(N, num_groups, -1), (-1,))
    shape = (1, C) + (1,) * (x.ndim - 2)
    mean, var = (s.repeat_interleave(C // num_groups, dim=1).reshape((N,) + shape[1:])
                 for s in (mean, var))
    return _normalize(xf, mean, var, weight, bias, eps, shape).to(dtype)


class LayerNorm(nn.Module):
    '''flax `nn.LayerNorm` over the last axis; `dim=1` over the channels of
    NCHW.'''

    def __init__(self, features, eps=1e-6, dtype=torch.float32, dim=-1):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.eps, self.dtype, self.dim = eps, dtype, dim

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps, self.dtype, self.dim)


class GroupNorm(nn.Module):
    '''flax `nn.GroupNorm(num_groups)`; `affine=False` is flax's
    use_scale=False, use_bias=False.'''

    def __init__(self, channels, num_groups, eps=1e-6, affine=True, dtype=torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(channels)) if affine else None
        self.bias = nn.Parameter(torch.zeros(channels)) if affine else None
        self.num_groups, self.eps, self.dtype = num_groups, eps, dtype

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps, self.dtype)


def dropout(x, rate: float, source: torch.Generator | Callable | None):
    '''flax `nn.Dropout(rate)` with `source` as its rng (module docstring).'''
    if source is None or rate == 0:
        return x
    keep = 1.0 - rate
    if isinstance(source, torch.Generator):
        mask = torch.empty(x.shape, dtype=torch.bool, device=x.device).bernoulli_(
            keep, generator=source)
    else:
        mask = source(tuple(x.shape), keep).to(x.device)
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))
