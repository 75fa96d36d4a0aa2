'''HiT in PyTorch: a token-grid transformer G and a residual conv D.

Counterpart of `animeface_tpu/implementations/HiT/model.py`, class for
class. Kept from the JAX package:
  * G works on tokens [B, N, C] in row-major order, as JAX does;
    `block_tokens`/`unblock_tokens` cut the grid into patch x patch
    blocks; `token_pixel_shuffle` reads each token's C channels as (2, 2,
    C / 4), which is NOT torch's PixelShuffle order (c, r, r);
  * `MultiAxisAttention`: q and o are raw [heads, dim, dim] parameters, k
    and v [dim, dim]; every head has the full width, the logits are
    unscaled and in float32, half the heads attend across blocks (the same
    position in every block) and half within a block; its output product
    is JAX's einsum 'bhmnd,hdv->bmnd', which sums o over its last axis;
  * `MultiQueryAttention`: cross-attention from the tokens to the latent
    tokens, bias-free Dense layers, logits in float32 scaled by
    head_dim ** -0.5;
  * each `Stage`: a zero-initialised position embedding, the latent
    cross-attention and an MLP (Dense, ReLU, Dense), then blocks of
    (multi-axis attention,) MLP, each with a pre-LayerNorm (epsilon 1e-6);
    a high-resolution stage (no patch size) emits RGB from a float32 Dense,
    added to a nearest 2x upsample of the running image; every stage but
    the last pixel-shuffles its tokens and projects them to the next width;
  * D: flat-width residual blocks (conv3x3, lrelu, conv3x3, average pool;
    skip conv1x1, average pool; sum / sqrt(2)), the minibatch stddev, a
    conv, and two Dense layers on the flattened map. The port flattens
    NCHW; the converter permutes the first Dense's rows from flax's NHWC;
  * an explicit compute `dtype`; images and logits come back in float32.
'''

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.implementations.StyleGAN2.model import MiniBatchStdDev
from animeface_tpu_torch.nnutils.initialize import get_initializer
from animeface_tpu_torch.nnutils.module import get_activation
from animeface_tpu_torch.nnutils.module.linen import Conv, Dense, LayerNorm, f32

_n002 = get_initializer('N002')


def block_tokens(x, patch: int):
    '''[B, H*W, C] -> [B, numblocks, patch^2, C].'''
    B, N, C = x.shape
    H = W = math.isqrt(N)
    x = x.reshape(B, H // patch, patch, W // patch, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H // patch) * (W // patch), patch * patch, C)


def unblock_tokens(x):
    B, M, N, C = x.shape
    H, patch = math.isqrt(M), math.isqrt(N)
    x = x.reshape(B, H, H, patch, patch, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, (H * patch) ** 2, C)


def token_pixel_shuffle(x):
    '''[B, N, C] -> [B, 4N, C // 4], channels read as (2, 2, C / 4).'''
    B, N, C = x.shape
    H = math.isqrt(N)
    x = x.reshape(B, H, H, 2, 2, C // 4).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, 4 * N, C // 4)


class MultiAxisAttention(nn.Module):
    def __init__(self, dim, num_heads, dtype=torch.float32, generator=None):
        super().__init__()
        self.q = nn.Parameter(_n002((num_heads, dim, dim), generator))
        self.k = nn.Parameter(_n002((dim, dim), generator))
        self.v = nn.Parameter(_n002((dim, dim), generator))
        self.o = nn.Parameter(_n002((num_heads, dim, dim), generator))
        self.num_heads, self.dtype = num_heads, dtype

    def forward(self, x):
        '''x: [B, M (blocks), N (patch^2), C].'''
        xd = x.to(self.dtype)
        Q = torch.einsum('bmnd,hdk->bhmnk', xd, self.q.to(self.dtype))
        h2 = self.num_heads // 2
        Q1, Q2 = f32(Q[:, :h2]), f32(Q[:, h2:])
        K = torch.einsum('bmnd,dk->bmnk', xd, self.k.to(self.dtype))
        V = torch.einsum('bmnd,dv->bmnv', xd, self.v.to(self.dtype))
        Kf = f32(K)
        # across the block axis (one position, every block)
        logits = torch.einsum('bhxyk,bzyk->bhyxz', Q1, Kf)
        O1 = torch.einsum('bhyxz,bzyv->bhxyv', torch.softmax(logits, -1).to(V.dtype), V)
        # within each block
        logits = torch.einsum('bhxyk,bxzk->bhxyz', Q2, Kf)
        O2 = torch.einsum('bhxyz,bxzv->bhxyv', torch.softmax(logits, -1).to(V.dtype), V)
        O = torch.cat([O1, O2], dim=1)
        return torch.einsum('bhmnd,hdv->bmnd', O, self.o.to(self.dtype))


class MultiQueryAttention(nn.Module):
    def __init__(self, dim, num_heads, latent_dim, dtype=torch.float32, generator=None):
        super().__init__()
        self.q = Dense(dim, dim, False, dtype, generator=generator)
        self.kv = Dense(latent_dim, dim * 2, False, dtype, generator=generator)
        self.out = Dense(dim, dim, False, dtype, generator=generator)
        self.dim, self.num_heads = dim, num_heads

    def forward(self, x, z):
        B, xN, _ = x.shape
        hd = self.dim // self.num_heads
        Q = self.q(x).reshape(B, xN, self.num_heads, hd).transpose(1, 2)
        KV = self.kv(z.to(x.dtype)).reshape(B, -1, 2, self.num_heads, hd)
        K, V = KV[:, :, 0].transpose(1, 2), KV[:, :, 1].transpose(1, 2)     # [B, h, zN, hd]
        attn = torch.matmul(f32(Q), f32(K).transpose(-1, -2)) * (hd ** -0.5)
        attn = torch.softmax(attn, -1).to(V.dtype)
        O = torch.matmul(attn, V).transpose(1, 2).reshape(B, xN, self.dim)
        return self.out(O)


class MLP(nn.Module):
    def __init__(self, dim, dtype=torch.float32, generator=None):
        super().__init__()
        self.fc1 = Dense(dim, dim, True, dtype, generator=generator)
        self.fc2 = Dense(dim, dim, True, dtype, generator=generator)

    def forward(self, x):
        return self.fc2(F.relu(self.fc1(x)))


class Stage(nn.Module):
    '''One resolution: low-res stages (a patch size) run multi-axis
    attention blocks, high-res stages MLP blocks and emit RGB.'''

    def __init__(self, dim, out_dim, num_heads, num_blocks, patch_size, num_tokens, latent_dim,
                 is_last=False, dtype=torch.float32, generator=None):
        super().__init__()
        self.patch_size, self.is_last, self.dtype = patch_size, is_last, dtype
        self.pos_embed = nn.Parameter(torch.zeros(1, num_tokens, dim))
        self.norm_q = LayerNorm(dim, dtype=dtype)
        self.cross = MultiQueryAttention(dim, num_heads, latent_dim, dtype, generator)
        self.norm_mlp = LayerNorm(dim, dtype=dtype)
        self.mlp = MLP(dim, dtype, generator)
        self.blocks = nn.ModuleList()
        for _ in range(num_blocks):
            block = nn.ModuleDict()
            if patch_size is not None:
                block['norm_attn'] = LayerNorm(dim, dtype=dtype)
                block['attn'] = MultiAxisAttention(dim, num_heads, dtype, generator)
            block['norm_mlp'] = LayerNorm(dim, dtype=dtype)
            block['mlp'] = MLP(dim, dtype, generator)
            self.blocks.append(block)
        self.to_rgb = (Dense(dim, 3, True, torch.float32, generator=generator)
                       if patch_size is None else None)
        self.proj = None if is_last else Dense(dim // 4, out_dim, True, dtype, generator=generator)

    def forward(self, x, z):
        x = x + self.pos_embed.to(x.dtype)
        x = x + self.cross(self.norm_q(x), z)
        x = x + self.mlp(self.norm_mlp(x))
        for block in self.blocks:
            if 'attn' in block:
                h = block_tokens(block['norm_attn'](x), self.patch_size)
                x = x + unblock_tokens(block['attn'](h))
            x = x + block['mlp'](block['norm_mlp'](x))
        image = None if self.to_rgb is None else self.to_rgb(f32(x))
        if not self.is_last:
            x = self.proj(token_pixel_shuffle(x))
        return x, image


class Generator(nn.Module):
    '''z [B, latent_dim] -> images [B, 3, S, S] float32, S = bottom * 2 **
    (len(dims) - 1).'''

    def __init__(self, latent_dim=128, dims=(512, 512, 256, 128, 64, 64), bottom=8,
                 low_stages=4, num_heads=(16, 8, 4, 4, 4, 4), num_blocks=(2, 2, 2, 2, 2, 2),
                 patch_sizes=(4, 4, 8, 8), dtype=torch.float32, generator=None):
        super().__init__()
        self.latent_dim, self.bottom, self.dims, self.dtype = latent_dim, bottom, dims, dtype
        self.input = Dense(latent_dim, dims[0] * bottom ** 2, True, dtype, generator=generator)
        self.latent = Dense(latent_dim, latent_dim * bottom ** 2, True, dtype, generator=generator)
        self.z_pos_embed = nn.Parameter(torch.zeros(1, bottom ** 2, latent_dim))
        self.stages = nn.ModuleList()
        for i, dim in enumerate(dims):
            is_last = i == len(dims) - 1
            self.stages.append(Stage(
                dim, None if is_last else dims[i + 1], num_heads[i], num_blocks[i],
                patch_sizes[i] if i < low_stages else None, (bottom * 2 ** i) ** 2, latent_dim,
                is_last, dtype, generator))

    def forward(self, z_in):
        B = z_in.shape[0]
        zd = z_in.to(self.dtype)
        x = self.input(zd).reshape(B, self.bottom ** 2, self.dims[0])
        z = self.latent(zd).reshape(B, self.bottom ** 2, self.latent_dim)
        z = z + self.z_pos_embed.to(z.dtype)
        image = None
        for stage in self.stages:
            x, img = stage(x, z)
            if img is not None:
                S = math.isqrt(img.shape[1])
                img = img.reshape(B, S, S, 3).permute(0, 3, 1, 2)
                image = img if image is None else (
                    F.interpolate(image, size=(S, S), mode='nearest') + img)
        return image


class Discriminator(nn.Module):
    '''images [B, 3, S, S] -> logits [B, 1] float32; width
    min(channels, max_channels) throughout (the JAX package's rule).'''

    def __init__(self, image_size=128, channels=32, max_channels=512, act_name='lrelu', bottom=8,
                 mbsd_groups=4, dtype=torch.float32, generator=None):
        super().__init__()
        self.act, self.dtype = get_activation(act_name), dtype
        num_downs = int(math.log2(image_size) - math.log2(bottom))
        c = min(channels, max_channels)
        self.input = Conv(3, c, 3, padding=1, dtype=dtype, generator=generator)
        self.blocks = nn.ModuleList(nn.ModuleList([
            Conv(c, c, 3, padding=1, dtype=dtype, generator=generator),
            Conv(c, c, 3, padding=1, dtype=dtype, generator=generator),
            Conv(c, c, 1, dtype=dtype, generator=generator)]) for _ in range(num_downs))
        self.mbsd = MiniBatchStdDev(mbsd_groups)
        self.conv = Conv(c + 1, c, 3, padding=1, dtype=dtype, generator=generator)
        self.fc = Dense(c * bottom ** 2, c, True, dtype, generator=generator)
        self.head = Dense(c, 1, True, torch.float32, generator=generator)

    def forward(self, x):
        x = self.act(self.input(x.to(self.dtype)))
        for conv1, conv2, skip in self.blocks:
            h = F.avg_pool2d(conv2(self.act(conv1(x))), 2)
            t = F.avg_pool2d(skip(x), 2)
            x = (h + t) / math.sqrt(2)
        x = self.act(self.conv(self.mbsd(x)))
        x = self.act(self.fc(x.reshape(x.shape[0], -1)))
        return self.head(f32(x))
