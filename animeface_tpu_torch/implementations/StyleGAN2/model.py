'''StyleGAN2 (skip G / residual D) in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/StyleGAN2/model.py`, class for
class. What is kept from the JAX package:
  * the factorized modulated conv: input scale -> shared-weight conv ->
    demodulation scale, with the affine and the demodulation in float32;
  * equalized learning rate as an apply-time factor gain/sqrt(fan) on
    weights stored N(0, 1/lr_mul);
  * an explicit compute `dtype` per module (convs in it, parameters in
    float32, the mapping network, affine, demod and the final tanh in
    float32). There is no autocast, which would move the affine to bf16;
  * noise injection is an argument: `InjectNoise` adds a given map, and with
    none it is the identity (the JAX deterministic mode, applied without a
    'noise' rng). `Generator` draws the maps from a `torch.Generator` when
    given one instead of maps.

`convert.py` maps the JAX package's parameters onto these modules.
'''

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.ops import setup_filter, filter2d, upfirdn2d
from animeface_tpu_torch.ops.activations import leaky_relu


def _leaky(x):
    return leaky_relu(x, 0.2)


def _normal(shape, std, generator):
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class ELRDense(nn.Module):
    '''Dense with equalized learning rate; weight [out, in].'''

    def __init__(self, in_features, features, gain=1.0, lr_mul=1.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.weight = _normal((features, in_features), 1.0 / lr_mul, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.coef = gain / np.sqrt(in_features)
        self.lr_mul = lr_mul
        self.dtype = dtype

    def forward(self, x):
        y = F.linear(x.to(self.dtype), (self.weight * self.coef).to(self.dtype))
        return (y + self.bias.to(self.dtype)) * self.lr_mul


class ELRConv(nn.Module):
    '''kxk conv with equalized learning rate; weight OIHW.'''

    def __init__(self, in_ch, features, kernel_size=3, gain=1.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        k = kernel_size
        self.weight = _normal((features, in_ch, k, k), 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.coef = gain / np.sqrt(in_ch * k * k)
        self.pad = (k - 1) // 2
        self.dtype = dtype

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype), (self.weight * self.coef).to(self.dtype),
                     padding=self.pad)
        return y + self.bias.to(self.dtype)[:, None, None]


class ModulatedConv(nn.Module):
    '''Style-modulated conv, factorized: conv(x*s, W)*d == groupconv(x, W*s*d).'''

    def __init__(self, in_ch, features, style_dim, kernel_size=3, demod=True,
                 gain=1.0, dtype=torch.float32, generator=None):
        super().__init__()
        k = kernel_size
        self.affine = ELRDense(style_dim, in_ch, dtype=torch.float32,
                               generator=generator)
        self.weight = _normal((features, in_ch, k, k), 1.0, generator)
        self.bias = nn.Parameter(torch.zeros(features))
        self.coef = gain / np.sqrt(in_ch * k * k)
        self.pad = (k - 1) // 2
        self.demod = demod
        self.dtype = dtype

    def forward(self, x, w_style):
        s = self.affine(w_style.float()) + 1.0                      # [B, in]
        w = self.weight.float() * self.coef
        x = x * s[:, :, None, None].to(x.dtype)
        y = F.conv2d(x.to(self.dtype), w.to(self.dtype), padding=self.pad)
        if self.demod:
            w2 = (w * w).sum(dim=(2, 3))                             # [out, in]
            d = torch.rsqrt((s * s) @ w2.t() + 1e-4)                 # [B, out]
            y = y * d[:, :, None, None].to(y.dtype)
        return y + self.bias.to(y.dtype)[:, None, None]


class InjectNoise(nn.Module):
    '''Adds a per-pixel noise map [B, 1, H, W] shared across channels; the
    identity when no map is given.'''

    def forward(self, x, noise=None):
        if noise is None:
            return x
        return x + noise.to(x.dtype)


_BLUR_KERNEL = [[1., 2., 1.], [2., 4., 2.], [1., 2., 1.]]
_BILINEAR_TAPS = np.asarray([1., 3., 3., 1.]) / 4.0
_UPBLUR_TAPS = np.convolve(_BILINEAR_TAPS, np.asarray([1., 2., 1.]) / 4.0)
_BILINEAR_2D = torch.from_numpy(np.outer(_BILINEAR_TAPS, _BILINEAR_TAPS).astype(np.float32))
_UPBLUR_2D = torch.from_numpy(np.outer(_UPBLUR_TAPS, _UPBLUR_TAPS).astype(np.float32))


class Blur2d(nn.Module):
    '''3x3 binomial blur through the FIR op.'''

    def forward(self, x):
        return filter2d(x, setup_filter(_BLUR_KERNEL))


def upsample2x_bilinear(x):
    return F.interpolate(x, scale_factor=2, mode='bilinear', align_corners=False)


def upsample2x_fused(x):
    '''Single-pass bilinear up2 as upfirdn (interior-exact vs bilinear resize).'''
    return upfirdn2d(x, _BILINEAR_2D, up=2, padding=[2, 1, 2, 1])


def upblur2x_fused(x):
    '''Fused bilinear-up2 + 3x3 blur as one upfirdn pass.'''
    return upfirdn2d(x, _UPBLUR_2D, up=2, padding=[3, 2, 3, 2])


def downsample2x_avg(x):
    return F.avg_pool2d(x, 2)


class StyleBlock(nn.Module):
    '''upsample -> blur -> [modconv -> noise -> lrelu] x num_conv.'''

    def __init__(self, in_ch, features, style_dim, num_conv=2,
                 fused_resample=True, dtype=torch.float32, generator=None):
        super().__init__()
        self.fused_resample = fused_resample
        self.convs = nn.ModuleList(
            ModulatedConv(in_ch if i == 0 else features, features, style_dim, 3,
                          dtype=dtype, generator=generator)
            for i in range(num_conv))
        self.noises = nn.ModuleList(InjectNoise() for _ in range(num_conv))
        self.blur = None if fused_resample else Blur2d()

    def forward(self, x, w_style, noise=None):
        x = upblur2x_fused(x) if self.fused_resample \
            else self.blur(upsample2x_bilinear(x))
        for i, (conv, inject) in enumerate(zip(self.convs, self.noises)):
            x = conv(x, w_style)
            x = inject(x, None if noise is None else noise[i])
            x = _leaky(x)
        return x


class ToImage(nn.Module):
    '''1x1 mod-conv (no demod) to RGB with skip accumulation.'''

    def __init__(self, in_ch, style_dim, image_channels=3, upsample=True,
                 fused_resample=True, dtype=torch.float32, generator=None):
        super().__init__()
        self.conv = ModulatedConv(in_ch, image_channels, style_dim, 1,
                                  demod=False, dtype=dtype, generator=generator)
        self.upsample = upsample
        self.fused_resample = fused_resample

    def forward(self, x, w_style, pre=None):
        x = self.conv(x, w_style)
        if pre is not None:
            x = x + pre
        if self.upsample:
            x = upsample2x_fused(x) if self.fused_resample else upsample2x_bilinear(x)
        return x


class PixelNorm(nn.Module):
    def forward(self, x):
        return x / (torch.sqrt((x * x).mean(dim=-1, keepdim=True)) + 1e-4)


class MiniBatchStdDev(nn.Module):
    '''Cross-sample stddev feature, one stat channel appended.

    Strided groups: group m = samples {m, m+n/G, ...} (the reference's
    reshape(G, -1) semantics); the whole batch is one group when it does not
    divide by the group size. `splits` cuts the batch into that many
    independent parts first, so a stacked [real; fake] batch never mixes
    the two in a group.
    '''

    def __init__(self, group_size=4, eps=1e-4):
        super().__init__()
        self.group_size = group_size
        self.eps = eps

    def forward(self, x, splits=1):
        N, C, H, W = x.shape
        assert N % splits == 0
        n = N // splits
        G = self.group_size if n % self.group_size == 0 else n
        y = x.float().reshape(splits, G, n // G, C, H, W)
        y = y - y.mean(dim=1, keepdim=True)
        y = torch.sqrt((y * y).mean(dim=1) + self.eps)              # [s, n/G, C, H, W]
        y = y.mean(dim=(2, 3, 4)).repeat(1, G)                      # sample i -> i mod n/G
        y = y.reshape(N, 1, 1, 1).expand(N, 1, H, W).to(x.dtype)
        return torch.cat([x, y], dim=1)


class Mapping(nn.Module):
    '''z -> w: pixel norm, then dense + lrelu layers with lr multiplier.'''

    def __init__(self, style_dim=512, num_layers=8, normalize=True, lr=0.01,
                 generator=None):
        super().__init__()
        self.norm = PixelNorm() if normalize else None
        self.layers = nn.ModuleList(
            ELRDense(style_dim, style_dim, lr_mul=lr, dtype=torch.float32,
                     generator=generator)
            for _ in range(num_layers))

    def forward(self, z):
        x = z.float()
        if self.norm is not None:
            x = self.norm(x)
        for layer in self.layers:
            x = _leaky(layer(x))
        return x


def _g_channel_ladder(image_size: int, channels: int, max_channels: int):
    chans = channels * (2 ** int(np.log2(image_size) - 2))
    ladder = [min(max_channels, chans)]
    resl = 4
    while resl < image_size:
        resl *= 2
        chans //= 2
        ladder.append(min(max_channels, chans))
    return ladder


class Synthesis(nn.Module):
    '''Skip-architecture synthesis with per-layer styles.'''

    def __init__(self, image_size=128, image_channels=3, style_dim=512,
                 channels=32, max_channels=512, num_conv=2, fused_resample=True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        ladder = _g_channel_ladder(image_size, channels, max_channels)
        self.ladder = ladder
        kw = dict(dtype=dtype, generator=generator)
        self.input = ModulatedConv(style_dim, ladder[0], style_dim, 3, **kw)
        self.input_to_image = ToImage(ladder[0], style_dim, image_channels,
                                      upsample=True, fused_resample=fused_resample, **kw)
        self.blocks = nn.ModuleList()
        self.to_images = nn.ModuleList()
        for i, ch in enumerate(ladder[1:]):
            last = i == len(ladder) - 2
            self.blocks.append(StyleBlock(ladder[i], ch, style_dim, num_conv,
                                          fused_resample, **kw))
            self.to_images.append(ToImage(ch, style_dim, image_channels,
                                          upsample=not last,
                                          fused_resample=fused_resample, **kw))
        self.num_conv = num_conv

    @property
    def num_layers(self):
        return len(self.ladder)

    def noise_shapes(self, batch_size):
        '''Shapes of the noise maps, in the order the layers add them.'''
        return [(batch_size, 1, 8 * 2 ** i, 8 * 2 ** i)
                for i in range(len(self.blocks)) for _ in range(self.num_conv)]

    def forward(self, x, styles, noise=None):
        '''styles: [L, B, style_dim]; noise: None or the list of maps.'''
        x = self.input(x, styles[0])
        image = pre = self.input_to_image(x, styles[0])
        k = self.num_conv
        for i, (block, to_image) in enumerate(zip(self.blocks, self.to_images)):
            x = block(x, styles[i + 1], None if noise is None else noise[i * k:(i + 1) * k])
            image = to_image(x, styles[i + 1], pre)
            pre = image
        return torch.tanh(image.float())


class Generator(nn.Module):
    '''Mapping + Synthesis + learned const input.

    forward(z, noise=None, injection=None) -> (image, w). `noise` is None
    (no noise), a list of maps (see `noise_shapes`) or a `torch.Generator`
    to draw them from. Style mixing: z = (z1, z2) with an integer
    `injection` layer index.
    '''

    def __init__(self, image_size=128, image_channels=3, style_dim=512,
                 channels=32, max_channels=512, block_num_conv=2,
                 map_num_layers=8, normalize_latent=True, map_lr=0.01,
                 fused_resample=True, dtype=torch.float32, generator=None):
        super().__init__()
        self.style_dim = style_dim
        self.map = Mapping(style_dim, map_num_layers, normalize_latent, map_lr,
                           generator=generator)
        self.synthesis = Synthesis(image_size, image_channels, style_dim, channels,
                                   max_channels, block_num_conv, fused_resample,
                                   dtype=dtype, generator=generator)
        self.const = _normal((1, style_dim, 4, 4), 1.0, generator)

    @property
    def num_layers(self):
        return self.synthesis.num_layers

    def noise_shapes(self, batch_size):
        return self.synthesis.noise_shapes(batch_size)

    def _noise(self, noise, batch_size):
        if isinstance(noise, torch.Generator):
            dtype = self.synthesis.input.dtype
            return [torch.randn(s, generator=noise, device=noise.device, dtype=dtype)
                    for s in self.noise_shapes(batch_size)]
        return noise

    def forward(self, z, noise=None, injection=None):
        L = self.num_layers
        if isinstance(z, (list, tuple)):
            assert len(z) == 2 and injection is not None
            w1, w2 = self.map(z[0]), self.map(z[1])
            layer_idx = torch.arange(L, device=w1.device)[:, None, None]
            styles = torch.where(layer_idx < injection, w1[None], w2[None])
            w_out = w1
        else:
            w_out = self.map(z)
            styles = w_out[None].expand(L, *w_out.shape)
        B = w_out.shape[0]
        x = self.const.expand(B, *self.const.shape[1:])
        return self.synthesis(x, styles, self._noise(noise, B)), w_out

    def map_w(self, z):
        '''z -> w through the mapping network only.'''
        return self.map(z)

    def synthesize_from_w(self, w, noise=None):
        '''Synthesis from a [B, style_dim] w (the path-length penalty's entry).'''
        styles = w[None].expand(self.num_layers, *w.shape)
        x = self.const.expand(w.shape[0], *self.const.shape[1:])
        return self.synthesis(x, styles, self._noise(noise, w.shape[0]))


class DBlock(nn.Module):
    '''Residual D block: convs -> down, skip 1x1 -> down, / sqrt(2).'''

    def __init__(self, in_ch, features, num_conv=2, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.convs = nn.ModuleList(
            ELRConv(in_ch if i == 0 else features, features, 3, dtype=dtype,
                    generator=generator)
            for i in range(num_conv))
        self.skip = ELRConv(in_ch, features, 1, dtype=dtype, generator=generator)

    def forward(self, x):
        t = x
        for conv in self.convs:
            x = _leaky(conv(x))
        t = self.skip(t)
        return (downsample2x_avg(x) + downsample2x_avg(t)) / math.sqrt(2)


class Discriminator(nn.Module):
    '''Residual discriminator. forward(x, splits=1): `splits` independent
    sub-batches for the minibatch-stddev statistics (2 for a stacked
    [real; fake] pass).'''

    def __init__(self, image_size=128, image_channels=3, channels=32,
                 max_channels=512, block_num_conv=2, mbsd_groups=4,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        chans = channels
        self.from_rgb = ELRConv(image_channels, chans, 1, **kw)
        self.blocks = nn.ModuleList()
        resl, ich, och = image_size, chans, chans
        while resl > 4:
            resl //= 2
            chans *= 2
            och = min(max_channels, chans)
            self.blocks.append(DBlock(ich, och, block_num_conv, **kw))
            ich = och
        self.mbsd = MiniBatchStdDev(mbsd_groups)
        self.conv = ELRConv(och + 1, och, 3, **kw)
        self.fc = ELRDense(och * 16, och, **kw)
        self.out = ELRDense(och, 1, **kw)
        self.dtype = dtype

    def forward(self, x, splits=1):
        x = _leaky(self.from_rgb(x.to(self.dtype)))
        for block in self.blocks:
            x = block(x)
        x = self.mbsd(x, splits)
        x = _leaky(self.conv(x))
        x = self.fc(x.reshape(x.shape[0], -1))
        return self.out(_leaky(x)).float()
