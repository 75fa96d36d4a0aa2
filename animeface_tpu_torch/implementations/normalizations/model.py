'''The normalizations ablation in PyTorch, NCHW: a reference-based
colorization G whose norms are selectable.

Counterpart of `animeface_tpu/implementations/normalizations/model.py`:
  * `Normalization(kind)`: 'in' each sample's channel over H, W; 'ln' each
    sample over C, H, W at once; both with the population variance and eps
    1e-5 (statistics in float32, cast back); 'lin' rho * ln + (1 - rho) *
    in, rho (from 0.5) clipped to [0, 1] where it is read; 'polin' a 1x1
    conv without bias over the channels [ln, in]; 'bn' flax's BatchNorm
    (momentum 0.9, eps 1e-5; its own scale and bias when affine). Every
    kind but 'bn' then takes gamma (ones) and beta (zeros) when affine;
  * `AdaptiveNormalization`: the norm without affine terms, scaled and
    shifted by gamma, beta = Dense(style) (no bias, float32) +
    `affine_bias` (ones for gamma, then zeros for beta);
  * `Generator`: a 1x1 conv and ReLU, then log2(image_size / bottom)
    stride-2 3x3 convs doubling the width (to `max_channels`), each with a
    norm and ReLU, for the content and likewise for the style image; the
    style's map flattened in H, W, C order (flax's NHWC reshape) into a
    Dense to `style_dim` and ReLU; `num_blocks` residual blocks (conv,
    adaptive norm, ReLU, conv, adaptive norm, (x + h) / sqrt(2)); as many
    nearest 2x upsamplings, each a 3x3 conv halving the width, an adaptive
    norm and ReLU; tanh of a 3x3 conv to RGB in float32.
D is SRGAN's (`SRGAN/model.py:Discriminator`, one scale, no spectral
norm). The layers sit in lists in flax's creation order (`convs`,
`norms`, `adanorms`), which `convert.py:convert_normalizations_generator`
fills.
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.implementations.SRGAN.model import Discriminator  # noqa: F401
from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.module.linen import Conv, Dense, f32

KINDS = ('bn', 'in', 'ln', 'lin', 'polin')


def _normalize(x, dims):
    xf = f32(x)
    mean = xf.mean(dim=dims, keepdim=True)
    var = (xf - mean).square().mean(dim=dims, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + 1e-5)).to(x.dtype)


def instance_norm(x):
    return _normalize(x, (2, 3))


def layer_norm(x):
    return _normalize(x, (1, 2, 3))


class Normalization(nn.Module):
    def __init__(self, kind, channels, affine=True, dtype=torch.float32, generator=None):
        super().__init__()
        if kind not in KINDS:
            raise Exception(f'Normalization: {kind}')
        self.kind = kind
        if kind == 'bn':
            self.bn = BatchNorm(channels, dtype=dtype, affine=affine)
        elif kind == 'lin':
            self.rho = nn.Parameter(torch.full((1,), 0.5))
        elif kind == 'polin':
            self.conv = Conv(2 * channels, channels, 1, use_bias=False, dtype=dtype,
                             generator=generator)
        self.gamma = self.beta = None
        if affine and kind != 'bn':
            self.gamma = nn.Parameter(torch.ones(channels))
            self.beta = nn.Parameter(torch.zeros(channels))

    def forward(self, x, train: bool = True):
        if self.kind == 'bn':
            return self.bn(x, train)
        if self.kind == 'in':
            out = instance_norm(x)
        elif self.kind == 'ln':
            out = layer_norm(x)
        elif self.kind == 'lin':
            rho = self.rho.clamp(0.0, 1.0)
            out = layer_norm(x) * rho + instance_norm(x) * (1 - rho)
        else:
            out = self.conv(torch.cat([layer_norm(x), instance_norm(x)], dim=1))
        if self.gamma is not None:
            out = self.gamma.view(1, -1, 1, 1) * out + self.beta.view(1, -1, 1, 1)
        return out


class AdaptiveNormalization(nn.Module):
    def __init__(self, kind, channels, style_dim, dtype=torch.float32, generator=None):
        super().__init__()
        self.norm = Normalization(kind, channels, False, dtype, generator)
        self.dense = Dense(style_dim, 2 * channels, use_bias=False, generator=generator)
        self.affine_bias = nn.Parameter(torch.cat([torch.ones(channels),
                                                   torch.zeros(channels)]))

    def forward(self, x, style, train: bool = True):
        norm = self.norm(x, train)
        gamma, beta = (self.dense(f32(style)) + self.affine_bias).chunk(2, dim=1)
        return (gamma[:, :, None, None].to(norm.dtype) * norm
                + beta[:, :, None, None].to(norm.dtype))


class Generator(nn.Module):
    def __init__(self, image_size=128, bottom=16, in_channels=1, style_channels=3, channels=32,
                 max_channels=512, style_dim=128, num_blocks=4, norm_name='in',
                 dtype=torch.float32, generator=None):
        super().__init__()
        num = int(math.log2(image_size) - math.log2(bottom))
        kw = dict(dtype=dtype, generator=generator)
        convs, norms, adanorms = [], [], []

        def encoder(in_ch):
            c = och = channels
            convs.append(Conv(in_ch, c, 1, **kw))
            for _ in range(num):
                c *= 2
                ich, och = och, min(max_channels, c)
                convs.append(Conv(ich, och, 3, 2, 1, **kw))
                norms.append(Normalization(norm_name, och, **kw))
            return c, och
        c, och = encoder(in_channels)
        _, sch = encoder(style_channels)
        bottom_size = image_size // 2 ** num
        self.dense = Dense(bottom_size * bottom_size * sch, style_dim, generator=generator)
        for _ in range(num_blocks):
            for _ in range(2):
                convs.append(Conv(och, och, 3, 1, 1, **kw))
                adanorms.append(AdaptiveNormalization(norm_name, och, style_dim, **kw))
        for _ in range(num):
            c //= 2
            ich, och = och, min(max_channels, c)
            convs.append(Conv(ich, och, 3, 1, 1, **kw))
            adanorms.append(AdaptiveNormalization(norm_name, och, style_dim, **kw))
        convs.append(Conv(och, 3, 3, 1, 1, **kw))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.adanorms = nn.ModuleList(adanorms)
        self.num, self.num_blocks, self.dtype = num, num_blocks, dtype

    def forward(self, content, style_img, train: bool = True):
        num = self.num
        convs, norms, adanorms = iter(self.convs), iter(self.norms), iter(self.adanorms)

        def encode(x):
            x = F.relu(next(convs)(x.to(self.dtype)))
            for _ in range(num):
                x = F.relu(next(norms)(next(convs)(x), train))
            return x
        x = encode(content)
        s = encode(style_img)
        style = F.relu(self.dense(f32(s.permute(0, 2, 3, 1).flatten(1))))
        for _ in range(self.num_blocks):
            h = F.relu(next(adanorms)(next(convs)(x), style, train))
            h = next(adanorms)(next(convs)(h), style, train)
            x = (x + h) / (2 ** 0.5)
        for _ in range(num):
            x = F.interpolate(x, scale_factor=2, mode='nearest')
            x = F.relu(next(adanorms)(next(convs)(x), style, train))
        return torch.tanh(f32(next(convs)(x)))
