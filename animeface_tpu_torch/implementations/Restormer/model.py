'''Restormer in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/Restormer/model.py`; the D
is NAFNet's patch D:
  * `GDFN`: a 1x1 conv to 2 int(C * 2.66), a depthwise 3x3, gelu (the tanh
    approximation, `jax.nn.gelu`'s default) of one half times the other, a
    1x1 conv back to C; no biases;
  * `MDTA`: attention over the channels: a 1x1 conv to q, k, v and a
    depthwise 3x3, each head's [head width, H W] rows of q and k divided by
    their L2 norm over H W plus 1e-8, the logits q k^T in float32 times ONE
    scalar temperature (from head width^-1/2), their softmax cast to v's
    dtype, times v, a 1x1 conv; no biases;
  * `Block`: x + s1 * MDTA(LN(x)), then x + s2 * GDFN(LN(x)), flax's
    LayerNorm over the channels of each pixel (eps 1e-6), the scales from
    1e-2;
  * `Generator`: a 3x3 conv to the base width; at each level but the
    last, blocks, then a 3x3 conv to half the width and NAFNet's
    `pixel_unshuffle` (twice the width); the last level's blocks; up, a 3x3
    conv to twice the width and `pixel_shuffle`, the skip CONCATENATED,
    then a 1x1 conv back to the level's width except at the outermost
    level, which runs at twice the base width; the refinement blocks there;
    a 3x3 conv to the image in float32, the input added with `skip_input`
    (a single channel repeated), and tanh (the JAX package's addition).
Each module keeps its layers in lists in flax's creation order (`convs`,
`blocks`), which `convert.py:convert_restormer_generator` fills.
'''

from __future__ import annotations

import torch
from torch import nn

from animeface_tpu_torch.implementations.NAFNet.model import (  # noqa: F401  (the D)
    Discriminator, pixel_unshuffle)
from animeface_tpu_torch.implementations.SRGAN.model import pixel_shuffle
from animeface_tpu_torch.nnutils.module.layers import get_activation
from animeface_tpu_torch.nnutils.module.linen import Conv, LayerNorm, f32


class GDFN(nn.Module):
    def __init__(self, channels, expansion=2.66, dtype=torch.float32, generator=None):
        super().__init__()
        mid = int(channels * expansion)
        self.convs = nn.ModuleList([
            Conv(channels, 2 * mid, 1, use_bias=False, dtype=dtype, generator=generator),
            Conv(2 * mid, 2 * mid, 3, padding=1, groups=2 * mid, use_bias=False, dtype=dtype,
                 generator=generator),
            Conv(mid, channels, 1, use_bias=False, dtype=dtype, generator=generator)])
        self.gelu = get_activation('gelu')

    def forward(self, x):
        expand, depthwise, out = self.convs
        h1, h2 = depthwise(expand(x)).chunk(2, dim=1)
        return out(self.gelu(h1) * h2)


def _unit_rows(t):
    return t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + 1e-8)


class MDTA(nn.Module):
    def __init__(self, channels, num_heads=4, dtype=torch.float32, generator=None):
        super().__init__()
        C = channels
        self.temperature = nn.Parameter(torch.tensor((C // num_heads) ** -0.5))
        self.convs = nn.ModuleList([
            Conv(C, 3 * C, 1, use_bias=False, dtype=dtype, generator=generator),
            Conv(3 * C, 3 * C, 3, padding=1, groups=3 * C, use_bias=False, dtype=dtype,
                 generator=generator),
            Conv(C, C, 1, use_bias=False, dtype=dtype, generator=generator)])
        self.num_heads = num_heads

    def forward(self, x):
        B, C, H, W = x.shape
        qkv, depthwise, out = self.convs
        q, k, v = (t.reshape(B, self.num_heads, C // self.num_heads, H * W)
                   for t in depthwise(qkv(x)).chunk(3, dim=1))
        q, k = _unit_rows(q), _unit_rows(k)
        logits = f32(q) @ f32(k).transpose(-1, -2) * f32(self.temperature)
        attn = torch.softmax(logits, dim=-1).to(v.dtype)
        return out((attn @ v).reshape(B, C, H, W))


class Block(nn.Module):
    def __init__(self, channels, num_heads=4, ff_expansion=2.66, dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.attn_scale = nn.Parameter(torch.tensor(1e-2))
        self.ff_scale = nn.Parameter(torch.tensor(1e-2))
        self.norms = nn.ModuleList(LayerNorm(channels, dtype=dtype, dim=1) for _ in range(2))
        self.attn = MDTA(channels, num_heads, dtype, generator)
        self.ff = GDFN(channels, ff_expansion, dtype, generator)

    def forward(self, x):
        x = x + self.attn_scale.to(x.dtype) * self.attn(self.norms[0](x))
        return x + self.ff_scale.to(x.dtype) * self.ff(self.norms[1](x))


class Generator(nn.Module):
    def __init__(self, num_blocks=(2, 6, 6, 8), num_heads=(1, 2, 4, 8), num_refinement_blocks=4,
                 ff_expansion=2.66, channels=48, skip_input=False, in_channels=1,
                 out_channels=3, dtype=torch.float32, generator=None):
        super().__init__()
        assert len(num_blocks) == len(num_heads)

        def conv(i, o, k=3):
            return Conv(i, o, k, padding=k // 2, use_bias=False, dtype=dtype, generator=generator)

        def blocks(c, n, heads):
            return [Block(c, heads, ff_expansion, dtype, generator) for _ in range(n)]
        base = c = channels
        convs, block_list = [conv(in_channels, c)], []
        for nb, nh in zip(num_blocks[:-1], num_heads[:-1]):
            block_list += blocks(c, nb, nh)
            convs.append(conv(c, c // 2))
            c *= 2
        block_list += blocks(c, num_blocks[-1], num_heads[-1])
        for nb, nh in zip(reversed(num_blocks[:-1]), reversed(num_heads[:-1])):
            convs.append(conv(c, 2 * c))
            c //= 2
            if c != base:
                convs.append(conv(2 * c, c, 1))
                width = c
            else:
                width = 2 * c
            block_list += blocks(width, nb, nh)
        block_list += blocks(width, num_refinement_blocks, num_heads[0])
        convs.append(conv(width, out_channels))
        self.convs, self.blocks = nn.ModuleList(convs), nn.ModuleList(block_list)
        self.num_blocks, self.num_refinement_blocks = tuple(num_blocks), num_refinement_blocks
        self.base, self.skip_input, self.dtype = base, skip_input, dtype

    def forward(self, x):
        convs, blocks = iter(self.convs), iter(self.blocks)

        def run(x, n):
            for _ in range(n):
                x = next(blocks)(x)
            return x
        skip = f32(x)
        c = self.base
        x = next(convs)(x.to(self.dtype))
        feats = []
        for nb in self.num_blocks[:-1]:
            x = run(x, nb)
            feats.append(x)
            x = pixel_unshuffle(next(convs)(x), 2)
            c *= 2
        x = run(x, self.num_blocks[-1])
        for nb in reversed(self.num_blocks[:-1]):
            x = pixel_shuffle(next(convs)(x), 2)
            c //= 2
            x = torch.cat([x, feats.pop()], dim=1)
            if c != self.base:
                x = next(convs)(x)
            x = run(x, nb)
        x = f32(next(convs)(run(x, self.num_refinement_blocks)))
        if self.skip_input:
            if skip.shape[1] != x.shape[1]:       # a one-channel line art to RGB
                skip = skip.repeat_interleave(x.shape[1] // skip.shape[1], dim=1)
            x = x + skip
        return torch.tanh(x)
