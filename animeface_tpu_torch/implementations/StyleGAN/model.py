'''StyleGAN (v1) in PyTorch, NCHW: the style-based progressive-growing G
(an 8-layer mapping, a learned constant, per-layer noise, leaky ReLU and
AdaIN) and a D with blurred downsampling, on PGGAN's growth design.

Counterpart of `animeface_tpu/implementations/StyleGAN/model.py`; it takes
`ELRConv`, `pixel_norm` and `MiniBatchStd` from the port's PGGAN model, as
the JAX module takes PGGAN's. What is kept:
  * `ELRDense`: weight N(0, 1 / lr_mul), runtime coefficient
    sqrt(2 / in) * lr_mul, bias times lr_mul; the mapping (lr_mul 0.01)
    runs in float32 after `pixel_norm` of z;
  * `AdaIN`: instance norm over H and W with the population variance, eps
    1e-5; the style's dense layer in float32; scale + 1 and shift cast to
    x's dtype;
  * `LayerEpilogue`: x + noise * noise_scale (noise_scale initialised to
    0), leaky ReLU 0.2, AdaIN. The noise is an input: a [B, 1, H, W] map
    per epilogue, two per block (`noise_shapes`), given to `Generator` as
    a list or drawn there from a `torch.Generator` (JAX draws them from its
    'noise' rng);
  * up- and downsampling with the [1, 2, 1] blur through `ops/upfirdn2d.py`
    (the transition's previous RGB upsampled with it, D's previous input
    and each D block's output downsampled with it, after a leaky ReLU),
    with the FIR's adjoint as its backward (`_FIR`).
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.implementations.PGGAN import model as pggan
from animeface_tpu_torch.implementations.PGGAN.model import (
    ELRConv, MiniBatchStd, blend, pixel_norm)
from animeface_tpu_torch.ops import setup_filter, upfirdn2d
from animeface_tpu_torch.ops.activations import leaky_relu

__all__ = ['ELRDense', 'AdaIN', 'LayerEpilogue', 'upsample_blur', 'blur_downsample', 'GBlock',
           'Mapping', 'Generator', 'DBlock', 'Discriminator', 'MiniBatchStd', 'noise_shapes']

G_CH = [(512, 512), (512, 512), (512, 256), (256, 128), (128, 64), (64, 32)]
RESOLUTIONS = pggan.RESOLUTIONS
_BLUR = [1., 2., 1.]


def _lrelu(x):
    return leaky_relu(x, 0.2)


class _FIR(torch.autograd.Function):
    '''`upfirdn2d` with a fixed filter, whose backward is again a `_FIR`:
    its adjoint (up and down swapped, the padding mirrored, the filter
    flipped), so the penalty's double backward differentiates no
    convolution weight. (PyTorch's double backward of a depthwise conv
    computes the filter's gradient anyway, one convolution per channel.)'''

    @staticmethod
    def forward(ctx, x, f, up, down, padding, flip, gain):
        ctx.save_for_backward(f)
        ctx.args, ctx.x_shape = (up, down, padding, flip, gain), x.shape
        return upfirdn2d(x, f, up=up, down=down, padding=padding, flip_filter=flip, gain=gain)

    @staticmethod
    def backward(ctx, dy):
        (f,) = ctx.saved_tensors
        up, down, (px0, _, py0, _), flip, gain = ctx.args
        ih, iw = ctx.x_shape[-2:]
        oh, ow = dy.shape[-2:]
        fh, fw = f.shape
        padding = (fw - px0 - 1, iw * up - ow * down + px0 - up + 1,
                   fh - py0 - 1, ih * up - oh * down + py0 - up + 1)
        return _FIR.apply(dy, f, down, up, padding, not flip, gain), None, None, None, None, \
            None, None


def upsample_blur(x):
    '''`upsample2d(x, setup_filter([1, 2, 1]), up=2)`: its padding and gain.'''
    return _FIR.apply(x, setup_filter(_BLUR, device=x.device), 2, 1, (2, 0, 2, 0), False, 4.0)


def blur_downsample(x):
    '''`downsample2d(x, setup_filter([1, 2, 1]), down=2)`: its padding.'''
    return _FIR.apply(x, setup_filter(_BLUR, device=x.device), 1, 2, (1, 0, 1, 0), False, 1.0)


class ELRDense(nn.Module):
    '''Dense layer with a runtime He coefficient and a learning-rate
    multiplier; weight [out, in].'''

    def __init__(self, in_features, features, lr_mul=1.0, dtype=torch.float32, generator=None):
        super().__init__()
        self.weight = nn.Parameter(torch.randn((features, in_features), generator=generator)
                                   / lr_mul)
        self.bias = nn.Parameter(torch.zeros(features))
        self.coef = float(np.sqrt(2.0 / in_features) * lr_mul)
        self.lr_mul, self.dtype = lr_mul, dtype

    def forward(self, x):
        return F.linear(x.to(self.dtype), (self.weight * self.coef).to(self.dtype),
                        (self.bias * self.lr_mul).to(self.dtype))


class AdaIN(nn.Module):
    '''Instance norm, then a style-conditional scale and shift.'''

    def __init__(self, channels, style_dim, generator=None):
        super().__init__()
        self.style = ELRDense(style_dim, channels * 2, generator=generator)

    def forward(self, x, style):
        mean = x.mean(dim=(2, 3), keepdim=True)
        var = x.var(dim=(2, 3), keepdim=True, unbiased=False)
        xn = (x - mean) * torch.rsqrt(var + 1e-5)
        scale, shift = self.style(style.float()).chunk(2, dim=1)
        return xn * (scale + 1.0)[:, :, None, None].to(x.dtype) \
            + shift[:, :, None, None].to(x.dtype)


class LayerEpilogue(nn.Module):
    '''Scaled noise, leaky ReLU, AdaIN.'''

    def __init__(self, channels, style_dim, generator=None):
        super().__init__()
        self.noise_scale = nn.Parameter(torch.zeros(()))
        self.adain = AdaIN(channels, style_dim, generator)

    def forward(self, x, style, noise):
        x = x + noise.to(x.dtype) * self.noise_scale.to(x.dtype)
        return self.adain(_lrelu(x), style)


class GBlock(nn.Module):
    '''[upsample_blur, conv,] epilogue, conv, epilogue.'''

    def __init__(self, in_ch, features, style_dim, is_first=False, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.is_first = is_first
        ins = [in_ch] if is_first else [in_ch, features]
        self.convs = nn.ModuleList(ELRConv(i, features, 3, 1, dtype, generator) for i in ins)
        self.epilogues = nn.ModuleList(
            LayerEpilogue(c, style_dim, generator)
            for c in ((in_ch if is_first else features), features))

    def forward(self, x, style, noise):
        if self.is_first:
            x = self.epilogues[0](x, style, noise[0])
            return self.epilogues[1](self.convs[0](x), style, noise[1])
        x = self.epilogues[0](self.convs[0](upsample_blur(x)), style, noise[0])
        return self.epilogues[1](self.convs[1](x), style, noise[1])


class Mapping(nn.Module):
    '''pixel_norm(z), then `num_layers` x (ELRDense lr_mul 0.01, leaky
    ReLU), in float32.'''

    def __init__(self, latent_dim, style_dim=512, num_layers=8, generator=None):
        super().__init__()
        self.layers = nn.ModuleList(
            ELRDense(latent_dim if i == 0 else style_dim, style_dim, lr_mul=0.01,
                     generator=generator) for i in range(num_layers))

    def forward(self, z):
        x = pixel_norm(z.float())
        for layer in self.layers:
            x = _lrelu(layer(x))
        return x


def noise_shapes(batch, depth):
    '''The noise maps' shapes for G at `depth`: two [B, 1, R, R] per block,
    R = 4 * 2^d.'''
    return [(batch, 1, 4 * 2 ** d, 4 * 2 ** d) for d in range(depth + 1) for _ in range(2)]


class Generator(nn.Module):
    '''z [B, latent] -> images [B, 3, 4 * 2^depth, same] float32. `noise`
    is a list of maps (`noise_shapes`; a longer list's first ones are
    used) or a `torch.Generator` to draw them from.'''

    def __init__(self, latent_dim=512, style_dim=512, max_depth=5, map_num_layers=8,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.latent_dim, self.style_dim, self.max_depth = latent_dim, style_dim, max_depth
        self.dtype = dtype
        self.mapping = Mapping(latent_dim, style_dim, map_num_layers, generator)
        self.const = nn.Parameter(torch.ones((1, style_dim, 4, 4)))
        self.blocks = nn.ModuleList(
            GBlock(style_dim if d == 0 else G_CH[d - 1][1], G_CH[d][1], style_dim, d == 0,
                   dtype, generator) for d in range(max_depth + 1))
        self.to_rgb = nn.ModuleList(ELRConv(G_CH[d][1], 3, 1, 0, dtype, generator)
                                    for d in range(max_depth + 1))

    def forward(self, z, depth: int, mode: str = 's', alpha=1.0, noise=None):
        B = z.shape[0]
        if noise is None or isinstance(noise, torch.Generator):
            noise = [torch.randn(s, generator=noise, device=z.device)
                     for s in noise_shapes(B, depth)]
        style = self.mapping(z)
        x = self.const.expand(B, -1, -1, -1).to(self.dtype)
        outs = []
        for d, block in enumerate(self.blocks[:depth + 1]):
            x = block(x, style, noise[2 * d:2 * d + 2])
            outs.append(x)
        rgb = self.to_rgb[depth](x)
        if mode == 't' and depth > 0:
            rgb = blend(upsample_blur(self.to_rgb[depth - 1](outs[-2])), rgb, alpha)
        return rgb.float()


class DBlock(pggan.DBlock):
    '''PGGAN's block, ending in leaky ReLU and `blur_downsample`.'''

    def downsample(self, x):
        return blur_downsample(_lrelu(x))


class Discriminator(pggan.Discriminator):
    '''PGGAN's D with `DBlock` above and the previous depth's input
    downsampled with the blur.'''

    block_cls = DBlock

    def downsample_input(self, x):
        return blur_downsample(x)
