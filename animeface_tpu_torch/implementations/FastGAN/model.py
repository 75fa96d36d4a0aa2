'''FastGAN (skip-layer-excitation G, self-supervised D with reconstruction
decoders) in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/FastGAN/model.py`, class for
class, at the recipe's knobs: `norm_name` 'bn' or 'in' (a conv has a bias
iff the norm is not 'bn'), `num_sle` None or an int. What is kept from the
JAX package:
  * flax's spectral norm, not torch's parametrization: every call runs one
    power iteration from the stored `u` (a buffer of [out]) on the weight
    as an [out, fan_in] matrix, with l2-normalisation x * rsqrt(sum(x^2) +
    1e-12), and divides the weight by sigma = u' . (W v), u' and v held
    constant; `train=True` stores u' (flax's `update_stats`);
  * flax's BatchNorm: batch statistics in float32 with the variance
    E[x^2] - E[x]^2 (clipped at 0), eps 1e-5, the running mean and the
    BIASED running variance at momentum 0.9, used when `train=False`;
    'in' is flax's GroupNorm(group_size=1) without scale or bias, eps 1e-6;
  * nearest resizes with JAX's sample positions: 2x up repeats each
    pixel, and the decoders' targets sample pixels 1, 3, 5, ... on a 2x
    down ('nearest-exact');
  * the dense input's [B, 4 * 4 * 2C] output read as NHWC; GLU over the
    channel axis (first half * sigmoid(second half)); the leaky ReLU's
    gradient at 0 of `jax.nn.leaky_relu`;
  * an explicit compute `dtype`: convs, dense and norms output it, the
    spectral norm and the norms' statistics run in float32, the images and
    the logits come back in float32.
The part quadrant `qid` of D's decoder_16 is an input (JAX draws it from
`part_key`): 0 is the top left of NHWC axes (1, 2), 1 rows h: columns :h,
2 rows :h columns h:, 3 the bottom right. D without a `qid` returns the
logits alone (a G phase needs nothing else; JAX computes the decoders and
discards their updates). `transposed=True` is refused (see `Generator`).
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.ops.activations import leaky_relu


def _lrelu(x):
    return leaky_relu(x, 0.2)


def _l2_normalize(x, eps=1e-12):
    return x * torch.rsqrt((x * x).sum() + eps)


class _SpectralNorm(nn.Module):
    '''A weight [out, ...] divided by its largest singular value, estimated
    by one power iteration from the buffer `u` on every call.'''

    def _init_sn(self, weight_shape, generator):
        fan_in = math.prod(weight_shape[1:])
        self.weight = nn.Parameter(torch.randn(weight_shape, generator=generator)
                                   / math.sqrt(fan_in))
        self.register_buffer('u', torch.randn(weight_shape[0], generator=generator))

    def normalized_weight(self, train: bool):
        w = self.weight
        mat = w.reshape(w.shape[0], -1)                          # [out, fan_in]
        with torch.no_grad():
            v = _l2_normalize(self.u @ mat)
            u = _l2_normalize(mat @ v)
        sigma = torch.dot(u, mat @ v)
        if train:
            with torch.no_grad():
                self.u.copy_(u)
        return w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))


class SNConv(_SpectralNorm):
    '''Spectral-normalized conv; `padding` 'SAME' (odd kernels, stride 1),
    'VALID' or an int.'''

    def __init__(self, in_ch, features, kernel_size=3, stride=1, padding='SAME',
                 use_bias=True, dtype=torch.float32, generator=None):
        super().__init__()
        self._init_sn((features, in_ch, kernel_size, kernel_size), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        if padding == 'SAME':
            assert stride == 1 and kernel_size % 2 == 1
            padding = kernel_size // 2
        self.padding = 0 if padding == 'VALID' else padding
        self.stride = stride
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        w = self.normalized_weight(train).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.conv2d(x.to(self.dtype), w, b, self.stride, self.padding)


class SNDense(_SpectralNorm):
    '''Spectral-normalized dense layer; weight [out, in].'''

    def __init__(self, in_features, features, use_bias=True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self._init_sn((features, in_features), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        w = self.normalized_weight(train).to(self.dtype)
        b = None if self.bias is None else self.bias.to(self.dtype)
        return F.linear(x.to(self.dtype), w, b)


class Norm(nn.Module):
    ''''bn': flax BatchNorm (momentum 0.9, eps 1e-5, biased running
    variance); 'in': flax GroupNorm(group_size=1), no affine, eps 1e-6.'''

    def __init__(self, channels, norm_name='bn', dtype=torch.float32):
        super().__init__()
        if norm_name not in ('bn', 'in'):
            raise ValueError(f'norm_name must be bn or in, got {norm_name!r}')
        self.bn = norm_name == 'bn'
        if self.bn:
            self.weight = nn.Parameter(torch.ones(channels))
            self.bias = nn.Parameter(torch.zeros(channels))
            self.register_buffer('running_mean', torch.zeros(channels))
            self.register_buffer('running_var', torch.ones(channels))
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if not self.bn or train:
            mean = xf.mean(dim=(0, 2, 3) if self.bn else (2, 3))
            var = ((xf * xf).mean(dim=(0, 2, 3) if self.bn else (2, 3)) - mean * mean).clamp_min(0)
        if not self.bn:
            y = (xf - mean[..., None, None]) * torch.rsqrt(var + 1e-6)[..., None, None]
            return y.to(self.dtype)
        if train:
            with torch.no_grad():
                self.running_mean.mul_(0.9).add_(mean.detach() * 0.1)
                self.running_var.mul_(0.9).add_(var.detach() * 0.1)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + 1e-5) * self.weight
        y = (xf - mean[:, None, None]) * mul[:, None, None] + self.bias[:, None, None]
        return y.to(self.dtype)


def _up2x(x):
    return F.interpolate(x, scale_factor=2, mode='nearest')


def _resize(x, size):
    '''jax.image.resize(..., 'nearest') to size x size.'''
    return x if x.shape[-1] == size else F.interpolate(x, size=(size, size),
                                                       mode='nearest-exact')


class UpBlock(nn.Module):
    '''2x nearest up -> SNConv(out * 2) -> norm -> GLU.'''

    def __init__(self, in_ch, features, norm_name='bn', dtype=torch.float32, generator=None):
        super().__init__()
        self.conv = SNConv(in_ch, features * 2, 3, use_bias=norm_name != 'bn', dtype=dtype,
                           generator=generator)
        self.norm = Norm(features * 2, norm_name, dtype)

    def forward(self, x, train: bool = True):
        return F.glu(self.norm(self.conv(_up2x(x), train), train), dim=1)


class SkipLayerExcitation(nn.Module):
    '''Gate high-resolution features by a squeeze of low-resolution ones.'''

    def __init__(self, low_ch, features, interp_size=4, dtype=torch.float32, generator=None):
        super().__init__()
        self.interp_size = interp_size
        self.squeeze = SNConv(low_ch, low_ch, interp_size, padding='VALID', dtype=dtype,
                              generator=generator)
        self.excite = SNConv(low_ch, features, 1, dtype=dtype, generator=generator)

    def forward(self, high, low, train: bool = True):
        pooled = F.avg_pool2d(low, low.shape[-1] // self.interp_size)
        y = self.excite(_lrelu(self.squeeze(pooled, train)), train)
        return high * torch.sigmoid(y)


class Generator(nn.Module):
    '''z [B, latent] -> images [B, image_channels, S, S] float32 in [-1, 1].'''

    def __init__(self, latent_dim=128, image_size=256, channels=32, max_channels=512,
                 interp_size=4, image_channels=3, bottom=4, norm_name='bn',
                 transposed=False, num_sle=None, dtype=torch.float32, generator=None):
        super().__init__()
        if transposed:
            raise NotImplementedError(
                "FastGAN transposed=True is not ported: the JAX package's init crashes "
                "(flax ConvTranspose with the explicit ((1, 1), (1, 1)) padding makes a "
                "k4/s2 layer 8x8 -> 14x14, not 16x16; 'mul got incompatible shapes for "
                "broadcasting')")
        kw = dict(dtype=dtype, generator=generator)
        num_ups = int(math.log2(image_size) - math.log2(bottom))
        c = channels * 2 ** num_ups
        och = min(max_channels, c)
        self.latent_dim = latent_dim
        self.bottom = bottom
        self.input = SNDense(latent_dim, och * 2 * bottom ** 2, use_bias=norm_name != 'bn', **kw)
        self.input_norm = Norm(och * 2, norm_name, dtype)
        ladder = []
        for _ in range(num_ups):
            c //= 2
            ladder.append(min(max_channels, c))
        if num_sle is None:
            num_sle = len(ladder[:-1]) // 2
        self.collect = list(range(num_sle))
        self.sle_at = {len(ladder) + i - num_sle - 1: i for i in range(num_sle)}
        ups, ich = [], och
        for ch in ladder:
            ups.append(UpBlock(ich, ch, norm_name, **kw))
            ich = ch
        self.ups = nn.ModuleList(ups)
        self.sles = nn.ModuleList(
            SkipLayerExcitation(ladder[j], ladder[i], interp_size, **kw)
            for i, j in sorted(self.sle_at.items(), key=lambda t: t[1]))
        self.out = SNConv(ich, image_channels, 3, **kw)

    def forward(self, z, train: bool = True):
        b = self.bottom
        x = self.input(z, train)
        x = x.reshape(x.shape[0], b, b, -1).permute(0, 3, 1, 2)     # NHWC order
        x = F.glu(self.input_norm(x, train), dim=1)
        feats = []
        for i, up in enumerate(self.ups):
            x = up(x, train)
            if i in self.collect:
                feats.append(x)
            if i in self.sle_at:
                j = self.sle_at[i]
                x = self.sles[j](x, feats[j], train)
        return torch.tanh(self.out(x, train).float())


class ResBlock(nn.Module):
    '''Strided-conv residual down block with an avg-pool skip.'''

    def __init__(self, in_ch, features, norm_name='bn', dtype=torch.float32, generator=None):
        super().__init__()
        bias = norm_name != 'bn'
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = SNConv(in_ch, features, 4, 2, 1, use_bias=bias, **kw)
        self.norm1 = Norm(features, norm_name, dtype)
        self.conv2 = SNConv(features, features, 3, use_bias=bias, **kw)
        self.norm2 = Norm(features, norm_name, dtype)
        self.skip = SNConv(in_ch, features, 1, use_bias=bias, **kw)

    def forward(self, x, train: bool = True):
        h = _lrelu(self.norm1(self.conv1(x, train), train))
        h = _lrelu(self.norm2(self.conv2(h, train), train))
        return h + _lrelu(self.skip(F.avg_pool2d(x, 2), train))


class SimpleDecoder(nn.Module):
    '''An 8x8 feature map -> an image_size image (float32, tanh).'''

    def __init__(self, in_ch, image_size=128, image_channels=3, bottom=8, norm_name='bn',
                 dtype=torch.float32, generator=None):
        super().__init__()
        ups, c = [], in_ch
        for _ in range(int(math.log2(image_size) - math.log2(bottom))):
            ups.append(UpBlock(c, c // 2, norm_name, dtype, generator))
            c //= 2
        self.ups = nn.ModuleList(ups)
        self.out = SNConv(c, image_channels, 3, dtype=dtype, generator=generator)

    def forward(self, x, train: bool = True):
        for up in self.ups:
            x = up(x, train)
        return torch.tanh(self.out(x, train).float())


def quadrant(x, qid):
    '''Quadrant `qid` (an int or a 0-dim tensor, no host sync) of NCHW x.'''
    h = x.shape[2] // 2
    qid = torch.as_tensor(qid, device=x.device)
    idx = torch.arange(h, device=x.device)
    x = x.index_select(2, idx + (qid % 2) * h)
    return x.index_select(3, idx + (qid // 2) * h)


class Discriminator(nn.Module):
    '''forward(x, qid=None, train) -> logits [B, 25] float32, or with a
    `qid` (logits, recon_loss, [recon, small, recon_part, img_part]).'''

    def __init__(self, image_size=256, init_down_size=256, image_channels=3, channels=32,
                 max_channels=1024, norm_name='bn', bottom=8, decoder_image_size=128,
                 dtype=torch.float32, generator=None):
        super().__init__()
        bias = norm_name != 'bn'
        kw = dict(dtype=dtype, generator=generator)
        init_downs = int(math.log2(image_size) - math.log2(init_down_size))
        num_downs = int(math.log2(init_down_size) - math.log2(bottom))
        self.decoder_image_size = decoder_image_size
        c = channels
        if init_downs == 0:
            stem = [SNConv(image_channels, c, 3, use_bias=bias, **kw)]
        else:
            stem = [SNConv(image_channels, c, 4, 2, 1, use_bias=bias, **kw)]
        stem_norms, ich = [], c
        for _ in range(init_downs - 1):
            c *= 2
            stem.append(SNConv(ich, min(max_channels, c), 4, 2, 1, use_bias=bias, **kw))
            ich = min(max_channels, c)
            stem_norms.append(Norm(ich, norm_name, dtype))
        self.stem = nn.ModuleList(stem)
        self.stem_norms = nn.ModuleList(stem_norms)
        blocks, resl, self.feat_at = [], init_down_size, {}
        for i in range(num_downs):
            resl //= 2
            c *= 2
            och = min(max_channels, c)
            blocks.append(ResBlock(ich, och, norm_name, **kw))
            if resl in (16, 8):
                self.feat_at[i] = resl
            ich = och
        self.blocks = nn.ModuleList(blocks)
        self.logits_conv = SNConv(ich, ich * 2, 1, use_bias=bias, **kw)
        self.logits_norm = Norm(ich * 2, norm_name, dtype)
        self.logits_out = SNConv(ich * 2, 1, 4, padding='VALID', **kw)
        feat_ch = {self.feat_at[i]: blocks[i].conv1.weight.shape[0] for i in self.feat_at}
        self.decoder_8 = SimpleDecoder(feat_ch[8], decoder_image_size, image_channels,
                                       norm_name=norm_name, **kw)
        self.decoder_16 = SimpleDecoder(feat_ch[16], decoder_image_size, image_channels,
                                        norm_name=norm_name, **kw)

    def forward(self, x, qid=None, train: bool = True):
        org = x
        h = _lrelu(self.stem[0](x, train))
        for conv, norm in zip(self.stem[1:], self.stem_norms):
            h = _lrelu(norm(conv(h, train), train))
        feats = {}
        for i, block in enumerate(self.blocks):
            h = block(h, train)
            if i in self.feat_at:
                feats[self.feat_at[i]] = h
        logits = _lrelu(self.logits_norm(self.logits_conv(h, train), train))
        logits = self.logits_out(logits, train)
        logits = logits.reshape(logits.shape[0], -1).float()
        if qid is None:
            return logits
        size = self.decoder_image_size
        small = _resize(org, size)
        recon = self.decoder_8(feats[8], train)
        img_part = _resize(quadrant(org, qid), size)
        recon_part = self.decoder_16(quadrant(feats[16], qid), train)
        recon_loss = ((recon - small) ** 2).mean() + ((recon_part - img_part) ** 2).mean()
        return logits, recon_loss, [recon, small, recon_part, img_part]
