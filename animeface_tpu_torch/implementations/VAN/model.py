'''The Visual Attention Network GAN in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/VAN/model.py`, class for class
(`_norm`, `AttentionModule`, `Block`, `Generator`, `Discriminator`). Kept
from the JAX package:
  * the LKA gate: a 5x5 depthwise conv (padding 2), a 7x7 depthwise conv
    with dilation 3 and padding 9, a 1x1 conv, multiplied into its input;
  * the block: norm, the gate, times the scalar `layer_scale1`; norm,
    1x1 expand, activation, 1x1, times the scalar `layer_scale2`; both
    scales start at 1e-6;
  * 'ln' is flax's GroupNorm(1, C) over C, H and W (epsilon 1e-6), 'gn'
    GroupNorm(16), 'in' GroupNorm(C) without scale or bias; 'bn' is
    refused, as in the JAX package; the activation from `get_activation`
    (the tanh GELU by default);
  * G: Dense, activation, [B, 4, 4, C] read as NHWC; each scale (but the
    first) norm, then nearest 2x up, conv3x3, blocks; norm, conv3x3, tanh
    in float32; D: a 7x7 stride-4 stem (padding 3) and 3x3 stride-2 downs
    with the channels * 2 ** (i + 1) ladder, each followed by a norm and
    blocks; norm, the mean over H and W, a float32 Dense;
  * an explicit compute `dtype`; images and logits come back in float32.
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.module import get_activation
from animeface_tpu_torch.nnutils.module.linen import Conv, Dense, GroupNorm, f32


def _norm(name, c, dtype):
    if name == 'ln':
        return GroupNorm(c, 1, dtype=dtype)
    if name == 'gn':
        return GroupNorm(c, 16, dtype=dtype)
    if name == 'in':
        return GroupNorm(c, c, affine=False, dtype=dtype)
    raise Exception(f'Normalization: {name} (bn unsupported in the TPU port)')


class AttentionModule(nn.Module):
    '''The LKA gate.'''

    def __init__(self, channels, dtype=torch.float32, generator=None):
        super().__init__()
        self.conv0 = Conv(channels, channels, 5, padding=2, groups=channels, dtype=dtype,
                          generator=generator)
        self.conv_spatial = Conv(channels, channels, 7, padding=9, dilation=3, groups=channels,
                                 dtype=dtype, generator=generator)
        self.conv1 = Conv(channels, channels, 1, dtype=dtype, generator=generator)

    def forward(self, x):
        return x * self.conv1(self.conv_spatial(self.conv0(x)))


class Block(nn.Module):
    def __init__(self, channels, expansion=4, norm_name='ln', act_name='gelu',
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.layer_scale1 = nn.Parameter(torch.tensor(1e-6))
        self.layer_scale2 = nn.Parameter(torch.tensor(1e-6))
        self.norm1 = _norm(norm_name, channels, dtype)
        self.attn = AttentionModule(channels, dtype, generator)
        self.norm2 = _norm(norm_name, channels, dtype)
        self.fc1 = Conv(channels, channels * expansion, 1, dtype=dtype, generator=generator)
        self.fc2 = Conv(channels * expansion, channels, 1, dtype=dtype, generator=generator)
        self.act = get_activation(act_name)

    def forward(self, x):
        x = x + self.layer_scale1.to(x.dtype) * self.attn(self.norm1(x))
        h = self.fc2(self.act(self.fc1(self.norm2(x))))
        return x + self.layer_scale2.to(x.dtype) * h


class Generator(nn.Module):
    '''z [B, latent_dim] -> images [B, out_channels, S, S] float32.'''

    def __init__(self, latent_dim=128, image_size=128, bottom=4, channels=64, max_channels=None,
                 blocks_per_scale=2, out_channels=3, norm_name='ln', act_name='gelu',
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.latent_dim, self.bottom, self.dtype = latent_dim, bottom, dtype
        num_ups = int(math.log2(image_size) - math.log2(bottom))
        max_c = max_channels if max_channels is not None else channels * 16
        c = channels * 2 ** num_ups
        och = min(max_c, c)
        self.input = Dense(latent_dim, och * bottom ** 2, True, dtype, generator=generator)
        self.act = get_activation(act_name)
        self.stages = nn.ModuleList()
        for i in range(num_ups):
            norm = _norm(norm_name, och, dtype) if i > 0 else nn.Identity()
            c //= 2
            ich, och = och, min(max_c, c)
            self.stages.append(nn.ModuleList(
                [norm, Conv(ich, och, 3, padding=1, dtype=dtype, generator=generator)]
                + [Block(och, 4, norm_name, act_name, dtype, generator)
                   for _ in range(blocks_per_scale)]))
        self.out_norm = _norm(norm_name, och, dtype)
        self.out = Conv(och, out_channels, 3, padding=1, dtype=dtype, generator=generator)

    def forward(self, z):
        x = self.act(self.input(z.to(self.dtype)))
        x = x.reshape(z.shape[0], self.bottom, self.bottom, -1).permute(0, 3, 1, 2)
        for norm, conv, *blocks in self.stages:
            x = conv(F.interpolate(norm(x), scale_factor=2, mode='nearest'))
            for block in blocks:
                x = block(x)
        return torch.tanh(f32(self.out(self.out_norm(x))))


class Discriminator(nn.Module):
    '''images [B, in_channels, S, S] -> logits [B, 1] float32.'''

    def __init__(self, layers=(3, 3, 9, 3), channels=64, max_channels=None, in_channels=3,
                 norm_name='ln', act_name='gelu', dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        max_c = max_channels if max_channels is not None else channels * 16
        c, ich = channels, in_channels
        self.stages = nn.ModuleList()
        for i, depth in enumerate(layers):
            c *= 2
            och = min(max_c, c)
            down = (Conv(ich, och, 7, stride=4, padding=3, dtype=dtype, generator=generator)
                    if i == 0 else
                    Conv(ich, och, 3, stride=2, padding=1, dtype=dtype, generator=generator))
            self.stages.append(nn.Sequential(
                down, _norm(norm_name, och, dtype),
                *(Block(och, 4, norm_name, act_name, dtype, generator) for _ in range(depth))))
            ich = och
        self.norm = _norm(norm_name, ich, dtype)
        self.head = Dense(ich, 1, True, torch.float32, generator=generator)

    def forward(self, x):
        x = x.to(self.dtype)
        for stage in self.stages:
            x = stage(x)
        return self.head(f32(self.norm(x).mean(dim=(2, 3))))
