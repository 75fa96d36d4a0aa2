'''The ConvNeXt GAN in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/ConvNeXt/model.py`, class for
class (`_norm`, `_instance_batch_norm`, `BLOCKS`, `ConvNeXtBlock`,
`ConvNextBlockFlex`, `Generator`, `Discriminator`). Kept from the JAX
package:
  * 'ln' is flax's GroupNorm(1, C): one group over C, H and W (epsilon
    1e-6), not a LayerNorm over channels; 'in' GroupNorm(C) without scale
    or bias; 'gn' GroupNorm(32); 'bn' the stateless batch statistics of
    `_instance_batch_norm` (mean and two-pass variance over N, H and W in
    float32, epsilon 1e-5, no scale, no running statistics);
  * the full `BLOCKS` ablation table; the flex block's zero-initialised
    scalar `gamma` on the residual branch; the tanh GELU;
  * G: Dense, the block's activation, [B, 4, 4, C] read as NHWC; each
    scale norm, nearest 2x up, conv3x3, blocks; a last norm for
    'convnext' and 'fewnorm'; conv3x3; tanh in float32;
  * D: the ConvNeXt-T trunk (4x4 stride-4 stem, GroupNorm(1) with
    epsilon 1e-6, 2x2 stride-2 downs), fixed `ConvNeXtBlock`s, the mean
    over H and W, a LayerNorm (1e-6) and a float32 Dense;
  * an explicit compute `dtype`; images and logits come back in float32.
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.module import get_activation
from animeface_tpu_torch.nnutils.module.linen import Conv, Dense, GroupNorm, LayerNorm, f32


def _instance_batch_norm(x, dtype):
    xf = f32(x)
    mu = xf.mean(dim=(0, 2, 3), keepdim=True)
    var = ((xf - mu) ** 2).mean(dim=(0, 2, 3), keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + 1e-5)).to(dtype)


class _BatchStats(nn.Module):
    '''The 'bn' entries: `_instance_batch_norm`, no parameters.'''

    def __init__(self, dtype):
        super().__init__()
        self.dtype = dtype

    def forward(self, x):
        return _instance_batch_norm(x, self.dtype)


def _norm(name, c, dtype):
    if name == 'bn':
        return _BatchStats(dtype)
    if name == 'in':
        return GroupNorm(c, c, affine=False, dtype=dtype)
    if name == 'ln':
        return GroupNorm(c, 1, dtype=dtype)
    if name == 'gn':
        return GroupNorm(c, 32, dtype=dtype)
    raise Exception(f'normalization: {name}')


#: the ConvNeXt-paper ablation ladder (JAX `BLOCKS`, verbatim)
BLOCKS = {
    'resnext': dict(norm_name='bn', act_name='relu', invert=False,
                    input_dconv=False, large_kernel=False, fewer_act=False,
                    fewer_norm=False),
    'invert': dict(norm_name='bn', act_name='relu', invert=True,
                   input_dconv=False, large_kernel=False, fewer_act=False,
                   fewer_norm=False),
    'kernel': dict(norm_name='bn', act_name='gelu', invert=True,
                   input_dconv=True, large_kernel=True, fewer_act=False,
                   fewer_norm=False),
    'gelu': dict(norm_name='bn', act_name='gelu', invert=True,
                 input_dconv=True, large_kernel=True, fewer_act=False,
                 fewer_norm=False),
    'fewact': dict(norm_name='bn', act_name='gelu', invert=True,
                   input_dconv=True, large_kernel=True, fewer_act=True,
                   fewer_norm=False),
    'fewnorm': dict(norm_name='bn', act_name='gelu', invert=True,
                    input_dconv=True, large_kernel=True, fewer_act=True,
                    fewer_norm=True),
    'convnext': dict(norm_name='ln', act_name='gelu', invert=True,
                     input_dconv=True, large_kernel=True, fewer_act=True,
                     fewer_norm=True),
    'smallkernel': dict(norm_name='ln', act_name='gelu', invert=True,
                        input_dconv=True, large_kernel=False, fewer_act=True,
                        fewer_norm=True),
}


class ConvNeXtBlock(nn.Module):
    '''D's fixed block: dw7x7, GroupNorm(1), 1x1 expand, GELU, 1x1, gamma
    residual.'''

    def __init__(self, channels, expansion=4, dtype=torch.float32, generator=None):
        super().__init__()
        self.dwconv = Conv(channels, channels, 7, padding=3, groups=channels, dtype=dtype,
                           generator=generator)
        self.norm = GroupNorm(channels, 1, dtype=dtype)
        self.pw1 = Conv(channels, channels * expansion, 1, dtype=dtype, generator=generator)
        self.pw2 = Conv(channels * expansion, channels, 1, dtype=dtype, generator=generator)
        self.gamma = nn.Parameter(torch.zeros(()))
        self.act = get_activation('gelu')

    def forward(self, x):
        h = self.pw2(self.act(self.pw1(self.norm(self.dwconv(x)))))
        return x + h * self.gamma.to(h.dtype)


class ConvNextBlockFlex(nn.Module):
    '''The block-structure ablation (a `BLOCKS` entry's knobs).'''

    def __init__(self, channels, ratio=4, norm_name='bn', act_name='relu', invert=False,
                 input_dconv=False, large_kernel=False, fewer_act=False, fewer_norm=False,
                 dtype=torch.float32, generator=None):
        super().__init__()
        C = channels
        mid = C * ratio if invert else C // ratio
        k = 7 if large_kernel else 3
        self.act = get_activation(act_name)
        self.input_dconv, self.fewer_act, self.fewer_norm = input_dconv, fewer_act, fewer_norm
        if input_dconv:
            self.conv1 = Conv(C, C, k, padding=k // 2, groups=C, dtype=dtype, generator=generator)
            self.norm1 = _norm(norm_name, C, dtype)
            self.conv2 = Conv(C, mid, 1, dtype=dtype, generator=generator)
        else:
            self.conv1 = Conv(C, mid, 1, dtype=dtype, generator=generator)
            self.norm1 = _norm(norm_name, mid, dtype)
            self.conv2 = Conv(mid, mid, k, padding=k // 2, groups=mid, dtype=dtype,
                              generator=generator)
        if not fewer_norm:
            self.norm2 = _norm(norm_name, mid, dtype)
        self.conv3 = Conv(mid, C, 1, dtype=dtype, generator=generator)
        if not fewer_norm:
            self.norm3 = _norm(norm_name, C, dtype)
        self.gamma = nn.Parameter(torch.zeros(()))

    def forward(self, x):
        residual = x
        x = self.norm1(self.conv1(x))
        if not self.fewer_act:
            x = self.act(x)
        x = self.conv2(x)
        if not self.fewer_norm:
            x = self.norm2(x)
        x = self.conv3(self.act(x))
        if not self.fewer_norm:
            x = self.norm3(x)
        x = residual + x * self.gamma.to(x.dtype)
        if not self.fewer_act:
            x = self.act(x)
        return x


class Generator(nn.Module):
    '''z [B, latent_dim] -> images [B, out_channels, S, S] float32.'''

    def __init__(self, latent_dim=128, image_size=128, bottom=4, channels=96, max_channels=None,
                 block_type='convnext', blocks_per_scale=2, out_channels=3, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.latent_dim, self.bottom, self.dtype = latent_dim, bottom, dtype
        num_ups = int(math.log2(image_size) - math.log2(bottom))
        max_c = max_channels if max_channels is not None else channels * 16
        bk = BLOCKS[block_type]
        c = channels * 2 ** num_ups
        och = min(max_c, c)
        self.input = Dense(latent_dim, och * bottom ** 2, True, dtype, generator=generator)
        self.act = get_activation(bk['act_name'])
        self.stages = nn.ModuleList()
        for _ in range(num_ups):
            c //= 2
            ich, och = och, min(max_c, c)
            self.stages.append(nn.ModuleList(
                [_norm(bk['norm_name'], ich, dtype),
                 Conv(ich, och, 3, padding=1, dtype=dtype, generator=generator)]
                + [ConvNextBlockFlex(och, 4, dtype=dtype, generator=generator, **bk)
                   for _ in range(blocks_per_scale)]))
        self.out_norm = (_norm(bk['norm_name'], och, dtype)
                         if block_type in ('convnext', 'fewnorm') else None)
        self.out = Conv(och, out_channels, 3, padding=1, dtype=dtype, generator=generator)

    def forward(self, z):
        x = self.act(self.input(z.to(self.dtype)))
        x = x.reshape(z.shape[0], self.bottom, self.bottom, -1).permute(0, 3, 1, 2)
        for norm, conv, *blocks in self.stages:
            x = conv(F.interpolate(norm(x), scale_factor=2, mode='nearest'))
            for block in blocks:
                x = block(x)
        if self.out_norm is not None:
            x = self.out_norm(x)
        return torch.tanh(f32(self.out(x)))


class Discriminator(nn.Module):
    '''images [B, in_channels, S, S] -> logits [B, 1] float32.'''

    def __init__(self, in_channels=3, depths=(3, 3, 9, 3), dims=(96, 192, 384, 768),
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.stages = nn.ModuleList()
        for i, depth in enumerate(depths):
            if i == 0:
                down = [Conv(in_channels, dims[0], 4, stride=4, dtype=dtype, generator=generator),
                        GroupNorm(dims[0], 1, dtype=dtype)]
            else:
                down = [GroupNorm(dims[i - 1], 1, dtype=dtype),
                        Conv(dims[i - 1], dims[i], 2, stride=2, dtype=dtype, generator=generator)]
            self.stages.append(nn.Sequential(
                *down, *(ConvNeXtBlock(dims[i], dtype=dtype, generator=generator)
                         for _ in range(depth))))
        self.norm = LayerNorm(dims[-1], dtype=dtype)
        self.head = Dense(dims[-1], 1, True, torch.float32, generator=generator)

    def forward(self, x):
        x = x.to(self.dtype)
        for stage in self.stages:
            x = stage(x)
        return self.head(f32(self.norm(x.mean(dim=(2, 3)))))
