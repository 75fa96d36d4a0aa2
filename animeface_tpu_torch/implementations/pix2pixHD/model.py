'''pix2pixHD in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/pix2pixHD/model.py`:
  * `ConvBlock` (JAX `_conv`): a conv after a padding of k // 2, reflected
    ('reflect') or zeros ('zeros': 1 for the stride-2 3x3, 2 for the
    stride-2 4x4, so a 4x4 map grows by one), then the norm and the
    activation; 'in' and 'bn' come from `get_normalization` ('in'
    affine-free, eps 1e-5), 'relu' and 'lrelu' from `get_activation`, any
    other name is the identity;
  * `ConvTBlock` (JAX `_convT`): flax's 3x3 stride-2 'SAME' transposed conv
    (`linen.ConvTranspose`, which crops its uneven padding), norm, act;
  * `ResBlock`: x + (conv-norm-act, conv-norm);
  * `GlobalG`: a 7x7 conv, `num_downs` stride-2 3x3 convs doubling the
    width, residual blocks, as many transposed convs halving it; returns
    (those features, tanh of a 7x7 conv to the image in float32);
  * `LocalG`: a 7x7 conv, a stride-2 3x3 conv to twice the width, the
    global features added, residual blocks, a transposed conv, tanh of a
    7x7 conv to the image in float32;
  * `Generator`: `global_g` (twice the width) on the input average-pooled
    2x2, `local_g` on the input and the global features; returns (local
    image, global image); `global_forward` runs `global_g` alone on an
    input already at half size (the global phase);
  * `SingleScaleD`: a 4x4 stride-2 conv without a norm, three more at
    twice the width with the norm, each with the activation and kept as a
    feature, a 3x3 conv (padding 1) to the logits in float32; returns
    (logits, features);
  * `Discriminator`: `num_scales` of them, each on the input average-pooled
    2x2 once more than the last; `num_scales` in a forward may run fewer
    (the finest first), the scales a loss reads.
Each module keeps its layers in lists in flax's creation order (`convs`,
`blocks`, `ups`, `norms`), which `convert.py:convert_pix2pixhd_*` fills.
'''

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.module.layers import get_activation, get_normalization
from animeface_tpu_torch.nnutils.module.linen import Conv, ConvTranspose, f32


def _norm(name, channels, dtype):
    if name in ('bn', 'in'):
        return get_normalization(name, channels, dtype)
    return nn.Identity()


def _act(name):
    return get_activation(name) if name in ('relu', 'lrelu') else (lambda x: x)


class ConvBlock(nn.Module):
    def __init__(self, in_ch, features, kernel, stride, norm_name, act_name, dtype,
                 padding_mode='reflect', use_norm=True, generator=None):
        super().__init__()
        self.pad = kernel // 2
        self.mode = 'reflect' if padding_mode == 'reflect' else 'constant'
        self.conv = Conv(in_ch, features, kernel, stride, dtype=dtype, generator=generator)
        self.norm = _norm(norm_name, features, dtype) if use_norm else nn.Identity()
        self.act = _act(act_name)

    def forward(self, x):
        if self.pad:
            x = F.pad(x, (self.pad,) * 4, mode=self.mode)
        return self.act(self.norm(self.conv(x)))


class ConvTBlock(nn.Module):
    def __init__(self, in_ch, features, norm_name, act_name, dtype, generator=None):
        super().__init__()
        self.conv = ConvTranspose(in_ch, features, 3, 2, dtype=dtype, generator=generator)
        self.norm = _norm(norm_name, features, dtype)
        self.act = _act(act_name)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class ResBlock(nn.Module):
    def __init__(self, channels, norm_name='in', act_name='relu', dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.convs = nn.ModuleList([
            ConvBlock(channels, channels, 3, 1, norm_name, act_name, dtype, generator=generator),
            ConvBlock(channels, channels, 3, 1, norm_name, '', dtype, generator=generator)])

    def forward(self, x):
        return x + self.convs[1](self.convs[0](x))


class GlobalG(nn.Module):
    def __init__(self, in_channels=1, out_channels=3, channels=64, num_downs=4, num_blocks=9,
                 norm_name='in', act_name='relu', dtype=torch.float32, generator=None):
        super().__init__()
        c = channels
        convs = [ConvBlock(in_channels, c, 7, 1, norm_name, act_name, dtype, generator=generator)]
        for _ in range(num_downs):
            convs.append(ConvBlock(c, 2 * c, 3, 2, norm_name, act_name, dtype, 'zeros',
                                   generator=generator))
            c *= 2
        self.blocks = nn.ModuleList(ResBlock(c, norm_name, act_name, dtype, generator)
                                    for _ in range(num_blocks))
        ups = []
        for _ in range(num_downs):
            ups.append(ConvTBlock(c, c // 2, norm_name, act_name, dtype, generator))
            c //= 2
        convs.append(ConvBlock(c, out_channels, 7, 1, '', '', dtype, use_norm=False,
                               generator=generator))
        self.convs, self.ups = nn.ModuleList(convs), nn.ModuleList(ups)
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        for conv in self.convs[:-1]:
            x = conv(x)
        for block in self.blocks:
            x = block(x)
        for up in self.ups:
            x = up(x)
        return x, torch.tanh(f32(self.convs[-1](x)))


class LocalG(nn.Module):
    def __init__(self, in_channels=1, out_channels=3, channels=32, num_blocks=3, norm_name='in',
                 act_name='relu', dtype=torch.float32, generator=None):
        super().__init__()
        c = channels
        self.convs = nn.ModuleList([
            ConvBlock(in_channels, c, 7, 1, norm_name, act_name, dtype, generator=generator),
            ConvBlock(c, 2 * c, 3, 2, norm_name, act_name, dtype, 'zeros', generator=generator),
            ConvBlock(c, out_channels, 7, 1, '', '', dtype, use_norm=False, generator=generator)])
        self.blocks = nn.ModuleList(ResBlock(2 * c, norm_name, act_name, dtype, generator)
                                    for _ in range(num_blocks))
        self.ups = nn.ModuleList([ConvTBlock(2 * c, c, norm_name, act_name, dtype, generator)])
        self.dtype = dtype

    def forward(self, x, global_feat):
        x = self.convs[1](self.convs[0](x.to(self.dtype)))
        x = x + global_feat.to(x.dtype)
        for block in self.blocks:
            x = block(x)
        return torch.tanh(f32(self.convs[2](self.ups[0](x))))


class Generator(nn.Module):
    def __init__(self, in_channels=1, out_channels=3, channels=32, local_num_blocks=3,
                 global_num_blocks=3, global_num_downs=4, norm_name='in', act_name='relu',
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.global_g = GlobalG(in_channels, out_channels, channels * 2, global_num_downs,
                                global_num_blocks, norm_name, act_name, dtype, generator)
        self.local_g = LocalG(in_channels, out_channels, channels, local_num_blocks, norm_name,
                              act_name, dtype, generator)

    def forward(self, x):
        g_feat, g_image = self.global_g(F.avg_pool2d(x, 2))
        return self.local_g(x, g_feat), g_image

    def global_forward(self, x):
        '''The global phase's forward on an input already at half size.'''
        return self.global_g(x)[1]


class SingleScaleD(nn.Module):
    def __init__(self, in_channels, channels=32, norm_name='in', act_name='lrelu',
                 dtype=torch.float32, generator=None):
        super().__init__()
        c = channels
        convs = [ConvBlock(in_channels, c, 4, 2, '', act_name, dtype, 'zeros', use_norm=False,
                           generator=generator)]
        for _ in range(3):
            convs.append(ConvBlock(c, 2 * c, 4, 2, norm_name, act_name, dtype, 'zeros',
                                   generator=generator))
            c *= 2
        self.convs = nn.ModuleList(convs)
        self.out = Conv(c, 1, 3, padding=1, dtype=dtype, generator=generator)
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        feats = []
        for conv in self.convs:
            x = conv(x)
            feats.append(x)
        return f32(self.out(x)), feats


class Discriminator(nn.Module):
    def __init__(self, in_channels=4, channels=32, num_scales=3, norm_name='in',
                 act_name='lrelu', dtype=torch.float32, generator=None):
        super().__init__()
        self.scales = nn.ModuleList(
            SingleScaleD(in_channels, channels, norm_name, act_name, dtype, generator)
            for _ in range(num_scales))

    def forward(self, x, num_scales=None):
        '''[(logits, features)] of the first `num_scales` (default all)
        scales, finest first.'''
        outs = []
        for i, scale in enumerate(self.scales[:num_scales]):
            if i:
                x = F.avg_pool2d(x, 2)
            outs.append(scale(x))
        return outs
