'''SRGAN in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/SRGAN/model.py`:
  * `pixel_shuffle`: [N, C r^2, H, W] -> [N, C, H r, W r], channel c r^2 +
    i r + j to pixel (i, j) of channel c, as the JAX depth-to-space on NHWC;
  * `sn_conv` (JAX `MaybeSNConv`): flax's spectral norm
    (`nnutils/spectral_norm.py:SNConv`, one power iteration a call, u
    stored with `train=True`) around a conv with xavier-normal kernels and
    zero biases, or the plain conv with `sn=False`;
  * `Act` ('prelu' a PReLU of its own, 'lrelu' 0.2, 'relu', 'tanh') and
    `Norm` ('' none, 'in' flax's instance norm with scale and bias, eps
    1e-6, 'bn' flax's BatchNorm, momentum 0.9, eps 1e-5);
  * G: a 7x7 conv, residual blocks (norm, act, conv, twice), norm, act,
    a 3x3 conv and the long skip, log2(scale) times act, a conv to 4x the
    width and the pixel shuffle, then act, a 7x7 conv to the image and
    tanh in float32;
  * D: `num_scale` patch discriminators, each on the input average-pooled
    2x2 once more than the last: a 4x4 stride-2 conv (padding 1) and act,
    `num_layers` times a 4x4 stride-2 conv at twice the width, norm and
    act, and a 4x4 stride-1 conv (padding 1) to the logits; each returns
    (logits in float32, the activations after each act).
Each module keeps its layers in lists in flax's creation order (`convs`,
`norms`, `acts`, `blocks`, `scales`), which `convert.py:convert_srgan_*`
fills from the flax names.
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.initialize import get_initializer
from animeface_tpu_torch.nnutils.module.layers import get_activation
from animeface_tpu_torch.nnutils.module.linen import GroupNorm, f32
from animeface_tpu_torch.nnutils.spectral_norm import SNConv


def pixel_shuffle(x, factor: int = 2):
    '''[N, C r^2, H, W] -> [N, C, H r, W r] (torch PixelShuffle semantics).'''
    return F.pixel_shuffle(x, factor)


def sn_conv(in_ch, features, kernel_size=3, stride=1, padding='SAME', sn=True, use_bias=True,
            dtype=torch.float32, generator=None):
    '''JAX `MaybeSNConv`: forward(x, train).'''
    return SNConv(in_ch, features, kernel_size, stride, padding, use_bias, dtype, generator,
                  use_sn=sn, weight_init=get_initializer('xavier'))


class Act(nn.Module):
    '''JAX `_act(name)`; 'prelu' holds its own slope (`prelu`).'''

    def __init__(self, name):
        super().__init__()
        if name not in ('prelu', 'lrelu', 'relu', 'tanh'):
            raise Exception(f'act: {name}')
        fn = get_activation(name)
        if isinstance(fn, nn.Module):
            self.prelu = fn
        else:
            self.fn = fn

    def forward(self, x):
        return self.prelu(x) if hasattr(self, 'prelu') else self.fn(x)


class Norm(nn.Module):
    '''JAX `_norm(name)`: '' none, 'in' or 'bn' (`norm`).'''

    def __init__(self, name, channels, dtype=torch.float32):
        super().__init__()
        if name == 'in':
            self.norm = GroupNorm(channels, channels, dtype=dtype)
        elif name == 'bn':
            self.norm = BatchNorm(channels, dtype=dtype)
        elif name != '':
            raise Exception(f'norm: {name}')
        self.kind = name

    def forward(self, x, train: bool = True):
        if self.kind == '':
            return x
        return self.norm(x, train) if self.kind == 'bn' else self.norm(x)


class ResBlock(nn.Module):
    '''x + (norm, act, conv) twice.'''

    def __init__(self, channels, sn=True, act_name='prelu', norm_name='in', use_bias=True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.norms = nn.ModuleList(Norm(norm_name, channels, dtype) for _ in range(2))
        self.acts = nn.ModuleList(Act(act_name) for _ in range(2))
        self.convs = nn.ModuleList(sn_conv(channels, channels, 3, sn=sn, use_bias=use_bias,
                                           dtype=dtype, generator=generator) for _ in range(2))

    def forward(self, x, train: bool = True):
        h = x
        for norm, act, conv in zip(self.norms, self.acts, self.convs):
            h = conv(act(norm(h, train)), train)
        return x + h


class Generator(nn.Module):
    def __init__(self, scale=2, image_channels=3, channels=64, num_blocks=5, sn=True,
                 act_name='prelu', norm_name='in', use_bias=True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        num_ups = int(math.log2(scale))
        kw = dict(sn=sn, use_bias=use_bias, dtype=dtype, generator=generator)
        self.convs = nn.ModuleList(
            [sn_conv(image_channels, channels, 7, **kw), sn_conv(channels, channels, 3, **kw)]
            + [sn_conv(channels, channels * 4, 3, **kw) for _ in range(num_ups)]
            + [sn_conv(channels, image_channels, 7, **kw)])
        self.blocks = nn.ModuleList(ResBlock(channels, sn, act_name, norm_name, use_bias, dtype,
                                             generator) for _ in range(num_blocks))
        self.norms = nn.ModuleList([Norm(norm_name, channels, dtype)])
        self.acts = nn.ModuleList(Act(act_name) for _ in range(num_ups + 2))
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        head, mid, *ups, tail = self.convs
        x = head(x.to(self.dtype), train)
        t = x
        for block in self.blocks:
            x = block(x, train)
        x = mid(self.acts[0](self.norms[0](x, train)), train) + t
        for act, conv in zip(self.acts[1:], ups):
            x = pixel_shuffle(conv(act(x), train), 2)
        return torch.tanh(f32(tail(self.acts[-1](x), train)))


class SingleScaleDiscriminator(nn.Module):
    def __init__(self, num_layers=3, channels=32, sn=True, act_name='lrelu', norm_name='in',
                 use_bias=True, image_channels=3, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(sn=sn, use_bias=use_bias, dtype=dtype, generator=generator)
        widths = [channels * 2 ** i for i in range(num_layers + 1)]
        self.convs = nn.ModuleList(
            [sn_conv(image_channels, channels, 4, 2, 1, **kw)]
            + [sn_conv(a, b, 4, 2, 1, **kw) for a, b in zip(widths, widths[1:])]
            + [sn_conv(widths[-1], 1, 4, 1, 1, **kw)])
        self.norms = nn.ModuleList(Norm(norm_name, c, dtype) for c in widths[1:])
        self.acts = nn.ModuleList(Act(act_name) for _ in widths)
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        feats = []
        x = self.acts[0](self.convs[0](x.to(self.dtype), train))
        feats.append(x)
        for conv, norm, act in zip(self.convs[1:-1], self.norms, self.acts[1:]):
            x = act(norm(conv(x, train), train))
            feats.append(x)
        return f32(self.convs[-1](x, train)), feats


class Discriminator(nn.Module):
    '''Multi-scale patch D: a list of (logits, feats), one a scale.'''

    def __init__(self, num_scale=2, num_layers=3, channels=32, sn=True, act_name='lrelu',
                 norm_name='in', use_bias=True, image_channels=3, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.scales = nn.ModuleList(
            SingleScaleDiscriminator(num_layers, channels, sn, act_name, norm_name, use_bias,
                                     image_channels, dtype, generator)
            for _ in range(num_scale))

    def forward(self, x, train: bool = True):
        outs = []
        for scale in self.scales:
            outs.append(scale(x, train))
            x = F.avg_pool2d(x, 2, 2)
        return outs
