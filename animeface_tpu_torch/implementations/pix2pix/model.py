'''pix2pix in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/pix2pix/model.py`:
  * G a UNet whose depth follows the image size (log2 of it: a 1x1
    bottleneck), widths min(512, 64 * 2^i): `Down` a 4x4 stride-2 conv
    with padding 1, flax's instance norm (GroupNorm with one channel a
    group, scale and bias, eps 1e-6) but on the first and the last, leaky
    ReLU 0.2 (ReLU on the last), dropout on the 512-wide ones but the
    last; `Up` a 4x4 stride-2 transposed conv (flax SAME), the instance
    norm, ReLU, dropout where 512 wide, then the skip concatenated after
    it; a last transposed conv to the image channels, tanh in float32;
  * D the conditional patch discriminator over (image ‖ condition): 4x4
    stride-2 convs 64, 128, 256, 512 with the instance norm on all but the
    first, leaky ReLU 0.2, a 3x3 conv with padding 1 to one logit a patch,
    in float32.
The layers are flax's (`nnutils/module/linen.py`): lecun-normal kernels,
zero biases, an explicit compute `dtype`. Dropout (rate `drop_out`, 0 by
default) is active only when a forward gets a `dropout` source.
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.module.linen import Conv, ConvTranspose, GroupNorm, dropout, f32
from animeface_tpu_torch.ops.activations import leaky_relu


def _inorm(channels, dtype):
    return GroupNorm(channels, channels, dtype=dtype)


class Down(nn.Module):
    def __init__(self, in_ch, features, normalize=True, leaky=True, drop_out=0.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.conv = Conv(in_ch, features, 4, 2, 1, dtype=dtype, generator=generator)
        self.norm = _inorm(features, dtype) if normalize else None
        self.leaky, self.drop_out = leaky, drop_out

    def forward(self, x, dropout_source=None):
        x = self.conv(x)
        if self.norm is not None:
            x = self.norm(x)
        x = leaky_relu(x, 0.2) if self.leaky else F.relu(x)
        return dropout(x, self.drop_out, dropout_source)


class Up(nn.Module):
    def __init__(self, in_ch, features, drop_out=0.0, dtype=torch.float32, generator=None):
        super().__init__()
        self.conv = ConvTranspose(in_ch, features, 4, 2, dtype=dtype, generator=generator)
        self.norm = _inorm(features, dtype)
        self.drop_out = drop_out

    def forward(self, x, dropout_source=None):
        return dropout(F.relu(self.norm(self.conv(x))), self.drop_out, dropout_source)


class Generator(nn.Module):
    '''UNet from `in_channels` to `image_channels`; bottleneck at 1x1.'''

    def __init__(self, image_size=256, image_channels=3, in_channels=1, drop_out=0.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        depth = int(math.log2(image_size))
        chans = [min(512, 64 * 2 ** i) for i in range(depth)]
        self.downs = nn.ModuleList()
        c = in_channels
        for i, ch in enumerate(chans):
            first, last = i == 0, i == depth - 1
            self.downs.append(Down(c, ch, normalize=not (first or last), leaky=not last,
                                   drop_out=drop_out if ch == 512 and not last else 0.0,
                                   dtype=dtype, generator=generator))
            c = ch
        self.ups = nn.ModuleList()
        for ch in reversed(chans[:-1]):
            self.ups.append(Up(c, ch, drop_out if ch == 512 else 0.0, dtype, generator))
            c = 2 * ch                            # and the skip of the same width
        self.out = ConvTranspose(c, image_channels, 4, 2, dtype=dtype, generator=generator)
        self.has_dropout = drop_out > 0
        self.dtype = dtype

    def forward(self, x, dropout=None):
        '''`dropout`: the masks' source (`linen.dropout`), None in eval.'''
        x = x.to(self.dtype)
        skips = []
        for down in self.downs:
            x = down(x, dropout)
            skips.append(x)
        skips.pop()                               # the bottleneck is no skip
        for up in self.ups:
            x = torch.cat([up(x, dropout), skips.pop()], dim=1)
        return torch.tanh(f32(self.out(x)))


class Discriminator(nn.Module):
    '''Conditional patch D over (image ‖ condition), `in_channels` in all.'''

    def __init__(self, in_channels=4, dtype=torch.float32, generator=None):
        super().__init__()
        chans = (64, 128, 256, 512)
        self.convs = nn.ModuleList()
        c = in_channels
        for ch in chans:
            self.convs.append(Conv(c, ch, 4, 2, 1, dtype=dtype, generator=generator))
            c = ch
        self.convs.append(Conv(c, 1, 3, 1, 1, dtype=dtype, generator=generator))
        self.norms = nn.ModuleList(_inorm(ch, dtype) for ch in chans[1:])
        self.dtype = dtype

    def forward(self, x):
        x = x.to(self.dtype)
        for i, conv in enumerate(self.convs[:-1]):
            x = conv(x)
            if i > 0:
                x = self.norms[i - 1](x)
            x = leaky_relu(x, 0.2)
        return f32(self.convs[-1](x))
