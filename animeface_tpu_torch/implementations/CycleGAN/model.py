'''CycleGAN in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/CycleGAN/model.py`:
  * `ReflectConv`: a conv after a padding of k // 2, reflected (G) or
    zeros (D: 2 for the 4x4 kernels, so each such map grows by one), with
    flax's spectral norm (`nnutils/spectral_norm.py:SNConv`: one power
    iteration a call from the stored u, u kept with `train=True`) unless
    `use_sn` is off; lecun-normal kernels, zero biases;
  * `Norm`: '' none, 'in' flax's `GroupNorm(group_size=1)` WITH scale and
    bias and eps 1e-6 (not `get_normalization`'s), 'bn' flax's BatchNorm
    (running statistics when `train=False`);
  * `ResBlock`: x + (conv, norm, act) `num_conv` times;
  * `Generator`: a 7x7 conv, norm, act; log2(image_size / target_resl)
    stride-2 3x3 convs doubling the width (to `max_channels`), each with
    norm and act; residual blocks; as many nearest 2x upsamplings, each a
    3x3 conv halving the width, norm and act; tanh of a 7x7 conv to the
    image in float32;
  * `Discriminator`: the PatchGAN: a 4x4 stride-2 conv and act, then
    `num_layers - 1` 4x4 convs doubling the width (the last at stride 1),
    each with norm and act, a 4x4 conv to one logit a patch in float32.
Each module keeps its layers in lists in flax's creation order (`convs`,
`norms`, `blocks`), which `convert.py:convert_cyclegan_*` fills.
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.module.layers import get_activation
from animeface_tpu_torch.nnutils.module.linen import GroupNorm, f32, lecun_normal
from animeface_tpu_torch.nnutils.spectral_norm import SNConv


class ReflectConv(nn.Module):
    def __init__(self, in_ch, features, kernel_size=3, stride=1, use_sn=False, use_bias=True,
                 reflect=True, dtype=torch.float32, generator=None):
        super().__init__()
        pad = kernel_size // 2
        self.reflect = pad if reflect else 0
        self.conv = SNConv(in_ch, features, kernel_size, stride, 0 if reflect else pad, use_bias,
                           dtype, generator, use_sn, lecun_normal)

    def forward(self, x, train: bool = True):
        if self.reflect:
            x = F.pad(x, (self.reflect,) * 4, mode='reflect')
        return self.conv(x, train)


class Norm(nn.Module):
    def __init__(self, name, channels, dtype=torch.float32):
        super().__init__()
        if name == 'in':
            self.norm = GroupNorm(channels, channels, dtype=dtype)
        elif name == 'bn':
            self.norm = BatchNorm(channels, dtype=dtype)
        elif name != '':
            raise Exception(f'norm: {name}')

    def forward(self, x, train: bool = True):
        norm = getattr(self, 'norm', None)
        if norm is None:
            return x
        return norm(x, train) if isinstance(norm, BatchNorm) else norm(x)


class ResBlock(nn.Module):
    def __init__(self, channels, num_conv=2, norm_name='in', act_name='relu', use_sn=False,
                 use_bias=True, dtype=torch.float32, generator=None):
        super().__init__()
        self.convs = nn.ModuleList(ReflectConv(channels, channels, 3, 1, use_sn, use_bias,
                                               dtype=dtype, generator=generator)
                                   for _ in range(num_conv))
        self.norms = nn.ModuleList(Norm(norm_name, channels, dtype) for _ in range(num_conv))
        self.act = get_activation(act_name)

    def forward(self, x, train: bool = True):
        h = x
        for conv, norm in zip(self.convs, self.norms):
            h = self.act(norm(conv(h, train), train))
        return x + h


class Generator(nn.Module):
    def __init__(self, image_size=128, in_channels=3, out_channels=3, target_resl=32, channels=32,
                 max_channels=1024, num_blocks=6, block_num_conv=2, norm_name='in',
                 act_name='relu', use_sn=False, use_bias=True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        num_downs = max(0, int(np.log2(image_size) - np.log2(target_resl)))

        def conv(i, o, k=3, s=1):
            return ReflectConv(i, o, k, s, use_sn, use_bias, dtype=dtype, generator=generator)
        c = och = channels
        convs, norms = [conv(in_channels, c, 7)], [Norm(norm_name, c, dtype)]
        for _ in range(num_downs):
            c *= 2
            ich, och = och, min(max_channels, c)
            convs.append(conv(ich, och, 3, 2))
            norms.append(Norm(norm_name, och, dtype))
        self.blocks = nn.ModuleList(ResBlock(och, block_num_conv, norm_name, act_name, use_sn,
                                             use_bias, dtype, generator)
                                    for _ in range(num_blocks))
        for _ in range(num_downs):
            c //= 2
            ich, och = och, min(max_channels, c)
            convs.append(conv(ich, och))
            norms.append(Norm(norm_name, och, dtype))
        convs.append(conv(och, out_channels, 7))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.act = get_activation(act_name)
        self.num_downs, self.dtype = num_downs, dtype

    def forward(self, x, train: bool = True):
        n = self.num_downs
        x = x.to(self.dtype)
        for conv, norm in zip(self.convs[:n + 1], self.norms[:n + 1]):
            x = self.act(norm(conv(x, train), train))
        for block in self.blocks:
            x = block(x, train)
        for conv, norm in zip(self.convs[n + 1:-1], self.norms[n + 1:]):
            x = F.interpolate(x, scale_factor=2, mode='nearest')
            x = self.act(norm(conv(x, train), train))
        return torch.tanh(f32(self.convs[-1](x, train)))


class Discriminator(nn.Module):
    def __init__(self, in_channels=3, channels=32, num_layers=3, norm_name='in', act_name='relu',
                 use_sn=False, use_bias=True, dtype=torch.float32, generator=None):
        super().__init__()

        def conv(i, o, s):
            return ReflectConv(i, o, 4, s, use_sn, use_bias, False, dtype, generator)
        c = channels
        convs, norms = [conv(in_channels, c, 2)], []
        for i in range(num_layers - 1):
            convs.append(conv(c, 2 * c, 2 if i < num_layers - 2 else 1))
            c *= 2
            norms.append(Norm(norm_name, c, dtype))
        convs.append(conv(c, 1, 1))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.act = get_activation(act_name)
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        x = self.act(self.convs[0](x.to(self.dtype), train))
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = self.act(norm(conv(x, train), train))
        return f32(self.convs[-1](x, train))
