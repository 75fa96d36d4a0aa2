'''DCGAN in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/DCGAN/model.py`: the channel
ladder from `image_size` ([512, 256, 128, 64] at 64px); G a 4x4
ConvTranspose 1x1 -> 4x4 (VALID), then 4x4 stride-2 ConvTranspose stages
(SAME: 2x), each with BatchNorm and ReLU, and a last stride-2 stage to the
image channels through tanh; D 4x4 stride-2 convs with padding 1, BatchNorm
on all but the first, leaky ReLU 0.2 with `jax.nn.leaky_relu`'s gradient
at 0, and a VALID 4x4 conv to one logit. No conv has a bias. Init N(0,
0.02) on the convs and N(1, 0.02) on the BatchNorm scales, drawn from a
`torch.Generator`. flax's BatchNorm (`nnutils/batchnorm.py`). An explicit
compute `dtype`; the images and the logits come back in float32.

A ConvTranspose weight is [in, out, 4, 4], as `F.conv_transpose2d` takes
it. flax's `nn.ConvTranspose` does not flip its kernel and PyTorch's does,
so the converter flips the kernel in both spatial axes
(`convert.convert_dcgan_generator`); then stride 1 padding 0 is flax's
VALID and stride 2 padding 1 its SAME.
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.ops.activations import leaky_relu


def channel_ladder(image_size: int, base: int = 64, cap: int = 1024):
    '''G's widths from 4x4 up (D's reversed): 128px -> [1024, 512, 256, 128, 64].'''
    n_up = int(np.log2(image_size // 4))
    return [min(cap, base * 2 ** (n_up - 1 - i)) for i in range(n_up)]


class Conv(nn.Module):
    '''A bias-free 4x4 conv, or ConvTranspose with `transpose`, in the
    compute dtype; weight N(0, 0.02).'''

    def __init__(self, in_ch, out_ch, stride, padding, transpose=False, dtype=torch.float32,
                 generator=None):
        super().__init__()
        shape = (in_ch, out_ch, 4, 4) if transpose else (out_ch, in_ch, 4, 4)
        self.weight = nn.Parameter(torch.randn(shape, generator=generator) * 0.02)
        self.stride, self.padding, self.transpose, self.dtype = stride, padding, transpose, dtype

    def forward(self, x):
        op = F.conv_transpose2d if self.transpose else F.conv2d
        return op(x.to(self.dtype), self.weight.to(self.dtype), stride=self.stride,
                  padding=self.padding)


def _norm(features, dtype, generator):
    return BatchNorm(features, dtype=dtype,
                     scale_init=lambda shape: 1 + torch.randn(shape, generator=generator) * 0.02)


class Generator(nn.Module):
    '''z [B, latent] -> images [B, channels, S, S] float32 in [-1, 1].'''

    def __init__(self, latent_dim=100, image_size=128, channels=3, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.latent_dim = latent_dim
        chans = channel_ladder(image_size)
        ins, outs = [latent_dim] + chans, chans + [channels]
        self.convs = nn.ModuleList(
            Conv(i, o, 1 if k == 0 else 2, 0 if k == 0 else 1, True, dtype, generator)
            for k, (i, o) in enumerate(zip(ins, outs)))
        self.norms = nn.ModuleList(_norm(c, dtype, generator) for c in chans)

    def forward(self, z, train: bool = True):
        x = z.reshape(z.shape[0], -1, 1, 1)
        for conv, norm in zip(self.convs, self.norms):
            x = F.relu(norm(conv(x), train))
        return torch.tanh(self.convs[-1](x)).float()


class Discriminator(nn.Module):
    '''images [B, channels, S, S] -> logits [B, 1] float32.'''

    def __init__(self, image_size=128, channels=3, dtype=torch.float32, generator=None):
        super().__init__()
        chans = list(reversed(channel_ladder(image_size)))
        self.convs = nn.ModuleList(
            [Conv(i, o, 2, 1, False, dtype, generator)
             for i, o in zip([channels] + chans[:-1], chans)]
            + [Conv(chans[-1], 1, 1, 0, False, dtype, generator)])
        self.norms = nn.ModuleList(_norm(c, dtype, generator) for c in chans[1:])

    def forward(self, x, train: bool = True):
        for i, conv in enumerate(self.convs[:-1]):
            x = conv(x)
            if i > 0:                       # no BatchNorm on the first conv
                x = self.norms[i - 1](x, train)
            x = leaky_relu(x, 0.2)
        x = self.convs[-1](x)
        return x.reshape(x.shape[0], -1).float()
