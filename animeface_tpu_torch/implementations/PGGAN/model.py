'''PGGAN in PyTorch, NCHW: progressive-growing G and D with equalized
learning rate, pixel norm, minibatch standard deviation and alpha-blended
transitions.

Counterpart of `animeface_tpu/implementations/PGGAN/model.py`. As there,
every block up to `max_depth` exists from construction, and `forward(...,
depth, mode, alpha)` runs the active prefix: `depth` is a Python int,
`mode` 's' (stable) or 't' (transition), `alpha` a float or a 0-dim
tensor. Growing changes no module. What is kept:
  * weights N(0, 1) and zero biases, scaled at run time: ELRConv by
    sqrt(2 / (in * k * k)), G's first 4x4 transposed conv of the 1x1
    latent by sqrt(2 / in);
  * `pixel_norm` over channels, eps 1e-8; leaky ReLU 0.2 with
    `jax.nn.leaky_relu`'s gradient at 0;
  * `MiniBatchStd`: the batch's population std (ddof 0, as `jnp.std`) in
    float32, averaged to one statistic, cast to x's dtype;
  * 2x nearest upsampling (an expand: its backward is a deterministic
    sum), 2x2 average pooling;
  * the transition blend (1 - alpha) * pre + alpha * cur in float32 (JAX
    promotes the compute dtype with alpha's float32); images and logits
    come back in float32.
A transposed conv's weight is [in, out, 4, 4] as `F.conv_transpose2d`
takes it; JAX's `conv_transpose` does not flip its kernel, so the
converter flips it (`convert.convert_pggan_generator`).
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.ops.activations import leaky_relu

G_PARAMS = [(None, 512), (512, 512), (512, 256), (256, 128), (128, 64), (64, 32)]
D_PARAMS = [(512, 512), (512, 512), (256, 512), (128, 256), (64, 128), (32, 64)]
RESOLUTIONS = [4, 8, 16, 32, 64, 128]


def pixel_norm(x):
    '''x / sqrt(mean over channels (dim 1) of x^2 + 1e-8).'''
    return x * torch.rsqrt((x * x).mean(dim=1, keepdim=True) + 1e-8)


def _lrelu(x):
    return leaky_relu(x, 0.2)


def upsample_nearest(x):
    '''2x nearest-neighbour upsampling.'''
    N, C, H, W = x.shape
    return x[:, :, :, None, :, None].expand(N, C, H, 2, W, 2).reshape(N, C, 2 * H, 2 * W)


def blend(pre, cur, alpha):
    '''(1 - alpha) * pre + alpha * cur, in float32.'''
    return (1 - alpha) * pre.float() + alpha * cur.float()


class ELRConv(nn.Module):
    '''kxk conv with a runtime He coefficient; weight OIHW N(0, 1).'''

    def __init__(self, in_ch, out_ch, kernel_size=3, padding=1, dtype=torch.float32,
                 generator=None):
        super().__init__()
        k = kernel_size
        self.weight = nn.Parameter(torch.randn((out_ch, in_ch, k, k), generator=generator))
        self.bias = nn.Parameter(torch.zeros(out_ch))
        self.coef = float(np.sqrt(2.0 / (in_ch * k * k)))
        self.padding, self.dtype = padding, dtype

    def forward(self, x):
        y = F.conv2d(x.to(self.dtype), (self.weight * self.coef).to(self.dtype),
                     padding=self.padding)
        return y + self.bias.to(y.dtype)[None, :, None, None]


class GBlock(nn.Module):
    '''The 4x4 input block (the latent through a 4x4 transposed conv) or a
    2x upsampling block; each conv followed by pixel norm and leaky ReLU.'''

    def __init__(self, in_ch, features, is_first=False, dtype=torch.float32, generator=None):
        super().__init__()
        self.is_first, self.dtype = is_first, dtype
        if is_first:
            self.kernel_t = nn.Parameter(torch.randn((in_ch, features, 4, 4),
                                                     generator=generator))
            self.coef = float(np.sqrt(2.0 / in_ch))
            ins = [features]
        else:
            ins = [in_ch, features]
        self.convs = nn.ModuleList(ELRConv(i, features, 3, 1, dtype, generator) for i in ins)

    def forward(self, x):
        if self.is_first:
            x = F.conv_transpose2d(x.to(self.dtype), (self.kernel_t * self.coef).to(self.dtype))
            x = _lrelu(pixel_norm(x))
        else:
            x = upsample_nearest(x)
        for conv in self.convs:
            x = _lrelu(pixel_norm(conv(x)))
        return x


class MiniBatchStd(nn.Module):
    '''Appends one channel: the mean over C, H, W of the batch's population
    std, computed in float32.'''

    def forward(self, x):
        N, _, H, W = x.shape
        stat = torch.std(x.float(), dim=0, correction=0).mean()
        return torch.cat([x, stat.to(x.dtype).expand(N, 1, H, W)], dim=1)


class DBlock(nn.Module):
    '''Two 3x3 convs and a 2x downsample, or the last block: minibatch std,
    a 3x3 conv, a 4x4 VALID conv and a 1x1 conv to one logit.'''

    def __init__(self, in_ch, features, is_last=False, dtype=torch.float32, generator=None):
        super().__init__()
        self.is_last = is_last
        if is_last:
            shapes = [(in_ch + 1, features, 3, 1), (features, features, 4, 0),
                      (features, 1, 1, 0)]
        else:
            shapes = [(in_ch, features, 3, 1), (features, features, 3, 1)]
        self.convs = nn.ModuleList(ELRConv(i, o, k, p, dtype, generator)
                                   for i, o, k, p in shapes)

    def downsample(self, x):
        return F.avg_pool2d(x, 2)

    def forward(self, x):
        if self.is_last:
            x = MiniBatchStd()(x)
            x = _lrelu(self.convs[0](x))
            x = _lrelu(self.convs[1](x))
            return self.convs[2](x).reshape(x.shape[0], -1)
        x = _lrelu(self.convs[0](x))
        return self.downsample(self.convs[1](x))


class Generator(nn.Module):
    '''z [B, latent] -> images [B, 3, 4 * 2^depth, same] float32.'''

    def __init__(self, latent_dim=100, max_depth=5, dtype=torch.float32, generator=None):
        super().__init__()
        self.latent_dim, self.max_depth = latent_dim, max_depth
        self.blocks = nn.ModuleList(
            GBlock(latent_dim if d == 0 else G_PARAMS[d - 1][1], G_PARAMS[d][1], d == 0, dtype,
                   generator) for d in range(max_depth + 1))
        self.to_rgb = nn.ModuleList(ELRConv(G_PARAMS[d][1], 3, 1, 0, dtype, generator)
                                    for d in range(max_depth + 1))

    def forward(self, z, depth: int, mode: str = 's', alpha=1.0):
        x = z.reshape(z.shape[0], -1, 1, 1)
        outs = []
        for block in self.blocks[:depth + 1]:
            x = block(x)
            outs.append(x)
        rgb = self.to_rgb[depth](x)
        if mode == 't' and depth > 0:
            rgb = blend(upsample_nearest(self.to_rgb[depth - 1](outs[-2])), rgb, alpha)
        return rgb.float()


class Discriminator(nn.Module):
    '''images [B, 3, 4 * 2^depth, same] -> logits [B, 1] float32.'''

    block_cls = DBlock

    def __init__(self, max_depth=5, dtype=torch.float32, generator=None):
        super().__init__()
        self.max_depth = max_depth
        self.from_rgb = nn.ModuleList(ELRConv(3, D_PARAMS[d][0], 1, 0, dtype, generator)
                                      for d in range(max_depth + 1))
        self.blocks = nn.ModuleList(
            self.block_cls(D_PARAMS[d][0], D_PARAMS[d][1], d == 0, dtype, generator)
            for d in range(max_depth + 1))

    def downsample_input(self, x):
        '''The images at half resolution, for the previous depth's head.'''
        return F.avg_pool2d(x, 2)

    def forward(self, x, depth: int, mode: str = 's', alpha=1.0):
        h = self.blocks[depth](_lrelu(self.from_rgb[depth](x)))
        if mode == 't' and depth > 0:
            pre = _lrelu(self.from_rgb[depth - 1](self.downsample_input(x)))
            h = blend(pre, h, alpha)
        for d in range(depth - 1, -1, -1):
            h = self.blocks[d](h)
        return h.float()
