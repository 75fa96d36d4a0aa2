'''TransGAN in PyTorch: a pure-transformer G and a ViT D.

Counterpart of `animeface_tpu/implementations/TransGAN/model.py`, class for
class (`Attention`, `EncoderBlock`, `token_upsample`, `Generator`,
`Discriminator`). Kept from the JAX package:
  * tokens [B, N, C] in row-major (h, w) order; G's dense output [B, 64 *
    C] read as [B, 64, C]; `token_upsample` is torch's PixelShuffle order
    (c, r, r) over the NHWC token grid (the JAX package's
    `SRGAN/model.py:pixel_shuffle`, copied here);
  * attention: qkv as one Dense, split (3, heads, head_dim); the logits
    q.k in float32 from the compute dtype's q and k (JAX's
    `preferred_element_type=float32`), times head_dim ** -0.5, the softmax
    in float32, cast back; plain products, no fused attention kernel;
  * flax's LayerNorm (epsilon 1e-6) and the tanh GELU; kernels, the
    position embeddings and D's cls token N(0, 0.02), biases 0;
  * dropout where flax puts it: on the attention probabilities
    (`attn_dropout`), after the projection and after the MLP (`dropout`),
    active only when a forward gets a `dropout` source
    (`nnutils/module/linen.py:dropout`), which the training step passes
    and the sampler does not;
  * D: a p x p stride-p patch conv, the cls token appended LAST, the
    position embedding over patches and cls, the blocks, a LayerNorm, and a
    float32 Dense on the last token;
  * an explicit compute `dtype`; images and logits come back in float32.
'''

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from animeface_tpu_torch.nnutils.initialize import get_initializer
from animeface_tpu_torch.nnutils.module import get_activation
from animeface_tpu_torch.nnutils.module.linen import Conv, Dense, LayerNorm, dropout, f32

_n002 = get_initializer('N002')


def pixel_shuffle(x, factor: int = 2):
    '''[N, H, W, C * r^2] -> [N, H * r, W * r, C], torch PixelShuffle order.'''
    N, H, W, C = x.shape
    r = factor
    c = C // (r * r)
    x = x.reshape(N, H, W, c, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(N, H * r, W * r, c)


def token_upsample(x):
    '''[B, N, C] -> [B, 4N, C/4] by a pixel shuffle of the token grid.'''
    B, N, C = x.shape
    H = math.isqrt(N)
    return pixel_shuffle(x.reshape(B, H, H, C), 2).reshape(B, 4 * N, C // 4)


class Attention(nn.Module):
    def __init__(self, dim, num_heads=4, qkv_bias=False, attn_dropout=0.0, proj_dropout=0.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.qkv = Dense(dim, dim * 3, qkv_bias, dtype, _n002, generator)
        self.proj = Dense(dim, dim, True, dtype, _n002, generator)
        self.num_heads, self.attn_dropout, self.proj_dropout = num_heads, attn_dropout, proj_dropout

    def forward(self, x, dropout_source=None):
        B, N, C = x.shape
        hd = C // self.num_heads
        qkv = self.qkv(x).reshape(B, N, 3, self.num_heads, hd).permute(2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]                         # [B, heads, N, hd]
        attn = torch.matmul(f32(q), f32(k).transpose(-1, -2)) * (hd ** -0.5)
        attn = torch.softmax(attn, dim=-1).to(v.dtype)
        attn = dropout(attn, self.attn_dropout, dropout_source)
        out = torch.matmul(attn, v).transpose(1, 2).reshape(B, N, C)
        return dropout(self.proj(out), self.proj_dropout, dropout_source)


class EncoderBlock(nn.Module):
    def __init__(self, dim, num_heads=4, mlp_ratio=4, qkv_bias=False, attn_dropout=0.0,
                 dropout=0.0, act_name='gelu', dtype=torch.float32, generator=None):
        super().__init__()
        self.norm1 = LayerNorm(dim, dtype=dtype)
        self.attn = Attention(dim, num_heads, qkv_bias, attn_dropout, dropout, dtype, generator)
        self.norm2 = LayerNorm(dim, dtype=dtype)
        self.fc1 = Dense(dim, dim * mlp_ratio, True, dtype, _n002, generator)
        self.fc2 = Dense(dim * mlp_ratio, dim, True, dtype, _n002, generator)
        self.act = get_activation(act_name)
        self.dropout = dropout

    def forward(self, x, dropout_source=None):
        x = x + self.attn(self.norm1(x), dropout_source)
        h = self.fc2(self.act(self.fc1(self.norm2(x))))
        return x + dropout(h, self.dropout, dropout_source)


class Generator(nn.Module):
    '''z [B, latent_dim] -> images [B, image_channels, S, S] float32, S =
    bottom_width * 2 ** (len(depths) - 1).'''

    def __init__(self, depths=(5, 4, 2), latent_dim=128, image_channels=3, bottom_width=8,
                 embed_dim=1024, num_heads=4, mlp_ratio=4, qkv_bias=False, dropout=0.0,
                 attn_dropout=0.0, act_name='gelu', dtype=torch.float32, generator=None):
        super().__init__()
        self.latent_dim, self.bottom_width, self.dtype = latent_dim, bottom_width, dtype
        self.has_dropout = bool(dropout or attn_dropout)
        resl, dim = bottom_width, embed_dim
        self.input = Dense(latent_dim, resl ** 2 * dim, True, dtype, _n002, generator)
        self.pos_embeds = nn.ParameterList()
        self.stages = nn.ModuleList()
        for index, depth in enumerate(depths):
            self.pos_embeds.append(nn.Parameter(_n002((1, resl ** 2, dim), generator)))
            self.stages.append(nn.ModuleList(
                EncoderBlock(dim, num_heads, mlp_ratio, qkv_bias, attn_dropout, dropout,
                             act_name, dtype, generator) for _ in range(depth)))
            if index < len(depths) - 1:
                resl, dim = resl * 2, dim // 4
        self.to_image = Conv(dim, image_channels, 1, dtype=dtype, init=_n002,
                             generator=generator)

    def forward(self, z, dropout=None):
        B = z.shape[0]
        resl = self.bottom_width
        x = self.input(z.to(self.dtype))
        x = x.reshape(B, resl ** 2, -1)
        for index, (pe, blocks) in enumerate(zip(self.pos_embeds, self.stages)):
            x = x + pe.to(x.dtype)
            for block in blocks:
                x = block(x, dropout)
            if index < len(self.stages) - 1:
                x = token_upsample(x)
                resl *= 2
        x = x.reshape(B, resl, resl, -1).permute(0, 3, 1, 2)
        return f32(self.to_image(x))

    @staticmethod
    def depths_len_from_target_width(target_width, bottom_width=8):
        return int(np.log2(target_width) - np.log2(bottom_width)) + 1


class Discriminator(nn.Module):
    '''images [B, image_channels, S, S] -> logits [B, 1] float32.'''

    def __init__(self, depth=7, image_size=128, patch_size=8, image_channels=3, embed_dim=384,
                 num_heads=4, mlp_ratio=4, qkv_bias=False, dropout=0.0, attn_dropout=0.0,
                 act_name='gelu', dtype=torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.has_dropout = bool(dropout or attn_dropout)
        n = (image_size // patch_size) ** 2 + 1
        self.patch = Conv(image_channels, embed_dim, patch_size, stride=patch_size, dtype=dtype,
                          init=_n002, generator=generator)
        self.cls_token = nn.Parameter(_n002((1, 1, embed_dim), generator))
        self.pos_embed = nn.Parameter(_n002((1, n, embed_dim), generator))
        self.blocks = nn.ModuleList(
            EncoderBlock(embed_dim, num_heads, mlp_ratio, qkv_bias, attn_dropout, dropout,
                         act_name, dtype, generator) for _ in range(depth))
        self.norm = LayerNorm(embed_dim, dtype=dtype)
        self.head = Dense(embed_dim, 1, True, torch.float32, _n002, generator)

    def forward(self, x, dropout=None):
        B = x.shape[0]
        x = self.patch(x.to(self.dtype)).flatten(2).transpose(1, 2)        # [B, N, E]
        cls = self.cls_token.to(x.dtype).expand(B, 1, -1)
        x = torch.cat([x, cls], dim=1) + self.pos_embed.to(x.dtype)
        for block in self.blocks:
            x = block(x, dropout)
        x = self.norm(x)[:, -1]
        return self.head(f32(x))
