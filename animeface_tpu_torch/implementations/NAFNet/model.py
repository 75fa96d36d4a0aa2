'''NAFNet in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/NAFNet/model.py`:
  * `pixel_unshuffle`: [N, C, H, W] -> [N, C r^2, H / r, W / r] in the JAX
    space-to-depth's order, channel (i r + j) C + c from pixel (i, j) of
    channel c (`F.pixel_unshuffle` puts it at c r^2 + i r + j);
  * `simple_gate`: the channels' first half times the second (through an
    activation when one is named; None, the default, is the identity);
  * `ConvBlock`: a 1x1 conv to twice the width, a depthwise 3x3, the gate,
    the simplified channel attention (the spatial mean through a 1x1 conv,
    multiplied in), a 1x1 conv;
  * `NAFBlock`: x + s1 * block(norm1(x)), then x + s2 * block(norm2(x)),
    with ONE `ConvBlock` whose weights both terms share and two scalar
    layer scales from 1e-3; 'ln' is flax's GroupNorm with one group (over
    C, H and W together, scale and bias, eps 1e-6), other names come from
    `get_normalization`;
  * `NAFNet`: a UNet whose depth is log2(image_size / bottom): NAF blocks,
    a 3x3 conv to a quarter of the next width and `pixel_unshuffle` down;
    a 3x3 conv to four times the width and `pixel_shuffle` up, the skip
    added; a 3x3 conv to the image, no output activation, float32;
  * `Discriminator`: the patch D: 4x4 stride-2 convs (padding 1), the
    first without a norm, flax's BatchNorm ('bn', running statistics when
    `train=False`) or another named norm, the activation, a 4x4 stride-1
    conv (padding 1) to one logit a patch, float32.
Each module keeps its layers in lists in flax's creation order (`convs`,
`blocks`, `norms`), which `convert.py:convert_nafnet_*` fills by the flax
names. The layers are flax's (`nnutils/module/linen.py`).
'''

from __future__ import annotations

import math

import torch
from torch import nn

from animeface_tpu_torch.implementations.SRGAN.model import pixel_shuffle
from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.module.layers import get_activation, get_normalization
from animeface_tpu_torch.nnutils.module.linen import Conv, GroupNorm, f32


def pixel_unshuffle(x, factor: int = 2):
    '''[N, C, H, W] -> [N, C r^2, H / r, W / r], the JAX channel order.'''
    N, C, H, W = x.shape
    r = factor
    x = x.reshape(N, C, H // r, r, W // r, r).permute(0, 3, 5, 1, 2, 4)
    return x.reshape(N, r * r * C, H // r, W // r)


def simple_gate(x, act_name=None):
    a, b = x.chunk(2, dim=1)
    if act_name is not None:
        b = get_activation(act_name)(b)
    return a * b


def _norm(name, channels, dtype):
    if name == 'ln':
        return GroupNorm(channels, 1, dtype=dtype)
    return get_normalization(name, channels, dtype)


class ConvBlock(nn.Module):
    def __init__(self, channels, act_name=None, dtype=torch.float32, generator=None):
        super().__init__()
        C = channels
        self.convs = nn.ModuleList([
            Conv(C, 2 * C, 1, dtype=dtype, generator=generator),
            Conv(2 * C, 2 * C, 3, padding=1, groups=2 * C, dtype=dtype, generator=generator),
            Conv(C, C, 1, dtype=dtype, generator=generator),
            Conv(C, C, 1, dtype=dtype, generator=generator)])
        self.act_name = act_name

    def forward(self, x):
        expand, depthwise, attention, out = self.convs
        h = simple_gate(depthwise(expand(x)), self.act_name)
        h = h * attention(h.mean(dim=(2, 3), keepdim=True))
        return out(h)


class NAFBlock(nn.Module):
    def __init__(self, channels, norm_name='ln', act_name=None, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.layer_scale1 = nn.Parameter(torch.tensor(1e-3))
        self.layer_scale2 = nn.Parameter(torch.tensor(1e-3))
        self.conv = ConvBlock(channels, act_name, dtype, generator)      # shared by both terms
        self.norms = nn.ModuleList(_norm(norm_name, channels, dtype) for _ in range(2))

    def forward(self, x):
        x = x + self.layer_scale1.to(x.dtype) * self.conv(self.norms[0](x))
        return x + self.layer_scale2.to(x.dtype) * self.conv(self.norms[1](x))


class NAFNet(nn.Module):
    def __init__(self, image_size=128, bottom=16, channels=64, max_channels=512,
                 blocks_per_scale=2, mid_blocks=6, norm_name='ln', act_name=None,
                 in_channels=1, out_channels=3, dtype=torch.float32, generator=None):
        super().__init__()
        num = int(math.log2(image_size) - math.log2(bottom))

        def conv(i, o):
            return Conv(i, o, 3, padding=1, dtype=dtype, generator=generator)

        def blocks(c, n):
            return [NAFBlock(c, norm_name, act_name, dtype, generator) for _ in range(n)]
        convs, block_list = [conv(in_channels, channels)], []
        och = c = channels
        for _ in range(num):
            c *= 2
            ich, och = och, min(max_channels, c)
            block_list += blocks(ich, blocks_per_scale)
            convs.append(conv(ich, och // 4))
        block_list += blocks(och, mid_blocks)
        for _ in range(num):
            c //= 2
            ich, och = och, min(max_channels, c)
            convs.append(conv(ich, och * 4))
            block_list += blocks(och, blocks_per_scale)
        convs.append(conv(och, out_channels))
        self.convs, self.blocks = nn.ModuleList(convs), nn.ModuleList(block_list)
        self.num, self.blocks_per_scale, self.mid_blocks = num, blocks_per_scale, mid_blocks
        self.dtype = dtype

    def forward(self, x):
        convs, blocks = iter(self.convs), iter(self.blocks)

        def run(x, n):
            for _ in range(n):
                x = next(blocks)(x)
            return x
        x = next(convs)(x.to(self.dtype))
        feats = []
        for _ in range(self.num):
            x = run(x, self.blocks_per_scale)
            feats.append(x)
            x = pixel_unshuffle(next(convs)(x), 2)
        x = run(x, self.mid_blocks)
        for _ in range(self.num):
            x = pixel_shuffle(next(convs)(x), 2) + feats.pop()
            x = run(x, self.blocks_per_scale)
        return f32(next(convs)(x))


class Discriminator(nn.Module):
    '''The patch D over (image ‖ line art), `in_channels` in all.'''

    def __init__(self, in_channels=4, num_layers=3, channels=64, max_channels=512,
                 norm_name='bn', act_name='lrelu', dtype=torch.float32, generator=None):
        super().__init__()
        c = channels
        convs = [Conv(in_channels, c, 4, 2, 1, dtype=dtype, generator=generator)]
        norms = []
        for _ in range(num_layers - 1):
            ich, c = c, min(max_channels, c * 2)
            convs.append(Conv(ich, c, 4, 2, 1, dtype=dtype, generator=generator))
            norms.append(BatchNorm(c, dtype=dtype) if norm_name == 'bn'
                         else _norm(norm_name, c, dtype))
        convs.append(Conv(c, 1, 4, 1, 1, dtype=dtype, generator=generator))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.act = get_activation(act_name)
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        x = self.act(self.convs[0](x.to(self.dtype)))
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = conv(x)
            x = norm(x, train) if isinstance(norm, BatchNorm) else norm(x)
            x = self.act(x)
        return f32(self.convs[-1](x))
