'''ESRGAN in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/ESRGAN/model.py`: the G of
residual-in-residual dense blocks on SRGAN's layers (`SRGAN/model.py`:
`sn_conv`, `Act`), and SRGAN's multi-scale D, which the recipe imports
from there:
  * `DenseBlock`: conv (hidden width) and act on x, then `num_conv - 2`
    times conv and act on everything so far concatenated, and a last conv
    back to the block's width;
  * `RRDB`: h = (h + dense(h)) / sqrt(2) over `num_dense` blocks, then
    (x + h) / sqrt(2);
  * G: a 7x7 conv, the RRDBs, a 3x3 conv and (x + skip) / sqrt(2),
    log2(scale) times a 2x nearest upsample, a conv and act, then a 7x7
    conv to the image and tanh in float32.
A division by sqrt(2) is in float32 (`f32`): JAX's numpy float64 divisor
promotes a bf16 stream to float32 there, and the convs cast it back.
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.implementations.SRGAN.model import Act, sn_conv
from animeface_tpu_torch.nnutils.module.linen import f32

SQRT2 = math.sqrt(2)


class DenseBlock(nn.Module):
    def __init__(self, channels, hid_channels, num_conv=5, sn=True, act_name='lrelu',
                 use_bias=True, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(sn=sn, use_bias=use_bias, dtype=dtype, generator=generator)
        self.convs = nn.ModuleList(
            [sn_conv(channels + k * hid_channels, hid_channels, 3, **kw)
             for k in range(num_conv - 1)]
            + [sn_conv(channels + (num_conv - 1) * hid_channels, channels, 3, **kw)])
        self.acts = nn.ModuleList(Act(act_name) for _ in range(num_conv - 1))

    def forward(self, x, train: bool = True):
        feats = [x]
        h = self.acts[0](self.convs[0](x, train))
        for conv, act in zip(self.convs[1:-1], self.acts[1:]):
            feats.append(h)
            h = act(conv(torch.cat(feats, dim=1), train))
        feats.append(h)
        return self.convs[-1](torch.cat(feats, dim=1), train)


class RRDB(nn.Module):
    '''Residual-in-residual dense block, residuals scaled 1/sqrt(2).'''

    def __init__(self, channels, hid_channels, num_dense=3, num_conv=5, sn=True,
                 act_name='lrelu', use_bias=True, dtype=torch.float32, generator=None):
        super().__init__()
        self.dense = nn.ModuleList(
            DenseBlock(channels, hid_channels, num_conv, sn, act_name, use_bias, dtype,
                       generator) for _ in range(num_dense))

    def forward(self, x, train: bool = True):
        h = x
        for dense in self.dense:
            h = f32(h + dense(h, train)) / SQRT2
        return f32(x + h) / SQRT2


class Generator(nn.Module):
    def __init__(self, scale=2, image_channels=3, channels=64, hid_channels=32, num_rrdb=7,
                 num_rd=3, num_conv=5, sn=True, act_name='lrelu', use_bias=True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        num_ups = int(math.log2(scale))
        kw = dict(sn=sn, use_bias=use_bias, dtype=dtype, generator=generator)
        self.convs = nn.ModuleList(
            [sn_conv(image_channels, channels, 7, **kw), sn_conv(channels, channels, 3, **kw)]
            + [sn_conv(channels, channels, 3, **kw) for _ in range(num_ups)]
            + [sn_conv(channels, image_channels, 7, **kw)])
        self.blocks = nn.ModuleList(
            RRDB(channels, hid_channels, num_rd, num_conv, sn, act_name, use_bias, dtype,
                 generator) for _ in range(num_rrdb))
        self.acts = nn.ModuleList(Act(act_name) for _ in range(num_ups))
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        head, mid, *ups, tail = self.convs
        x = head(x.to(self.dtype), train)
        t = x
        for block in self.blocks:
            x = block(x, train)
        x = f32(mid(x, train) + t) / SQRT2
        for conv, act in zip(ups, self.acts):
            x = act(conv(F.interpolate(x, scale_factor=2, mode='nearest'), train))
        return torch.tanh(f32(tail(x, train)))
