'''Unconditional BigGAN and BigGAN-deep in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/BigGAN/model.py`, class for
class: `_arch` (copied verbatim, with its 32/64px extension and the deep
expansion), `SNDense`/`SNConv`, `ConditionalNorm`, `GBlock`/`GBlockDeep`,
`DBlock`/`DBlockDeep`, `SelfAttention`, `SqueezeExcitation` (SEBigGAN's
'se'), `LambdaLayer` ('ll'), `Generator` and `Discriminator`. What is kept
from the JAX package:
  * flax's spectral norm (`nnutils/spectral_norm.py`) around every conv and
    dense layer, kernels from flax's truncated `xavier_normal`, biases at 0;
    with `use_sn=False` the plain layer;
  * the conditional norm: flax BatchNorm without scale or bias (eps 1e-5,
    momentum 0.9, biased running variance) or, for 'in', GroupNorm with one
    channel per group (eps 1e-6); out = norm * (1 - gain(z)) + bias(z),
    the whole z into every layer;
  * G's dense output [B, 4 * 4 * C] read as NHWC; nearest 2x up as a pixel
    repeat; D's average pools; the sum (not the mean) over H and W before
    D's last dense layer;
  * attention once: in G after the first block at the table's resolution,
    in D after the last block there. SAGAN's 1x1 convs have no bias, phi
    and g are 2x2 max-pooled, positions flatten row-major (H, then W), the
    softmax is in float32, gamma starts at 0. SE gates by a sigmoid in
    float32. The lambda layer's softmax runs over positions, its channel
    index is h * keys + k (NHWC's reshape), `pos_emb` is [n, n, keys, u];
  * an explicit compute `dtype`: layers output it, norms' statistics and the
    power iteration run in float32, images and logits come back in float32.
A 'prelu' activation is a module, `act_fn`, of each block and of G and D
(flax's PReLU_0 there: one slope for every use in the module).
Modules are built with their input widths (PyTorch needs them where flax
infers them); the lambda layer needs its resolution for `pos_emb`.
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import BatchNorm, batch_norm, instance_norm
from animeface_tpu_torch.nnutils.initialize import get_initializer
from animeface_tpu_torch.nnutils.module import get_activation
from animeface_tpu_torch.nnutils import spectral_norm as sn

# the reference's GEN_ARCH out-multipliers (in = [16] + out[:-1]) and
# DIS_ARCH out-multipliers (in = [0] + out[:-1]); att = attention resl
_GEN_OUT = {128: [16, 8, 4, 2, 1],
            256: [16, 8, 8, 4, 2, 1],
            512: [16, 8, 8, 4, 2, 1, 1]}
_GEN_ATT = {128: 64, 256: 128, 512: 64}
_DIS_OUT = {128: [2, 4, 8, 16, 16, 16],
            256: [2, 4, 8, 8, 16, 16, 16],
            512: [1, 2, 4, 8, 8, 16, 16, 16]}


def _arch(image_size: int, deep: bool = False):
    '''G/D ladders, as the JAX function returns them: gen = dict(inm, out,
    up, resl, att) and dis = dict(inm, out, down, resl, att, input_conv),
    where D's inm entry 0 means "image channels".'''
    n_up = int(np.log2(image_size)) - 2          # from 4x4
    g_out = _GEN_OUT.get(image_size, [16, 8, 8, 4, 2, 1][-n_up:])
    g_in = [16] + g_out[:-1]
    g_resl = [2 ** (3 + i) for i in range(n_up)]
    g_att = _GEN_ATT.get(image_size, min(64, image_size // 2))
    d_out = _DIS_OUT.get(image_size,
                         ([2, 4, 8, 16, 16][:n_up] + [16])[-(n_up + 1):])
    d_att = 64 if image_size in _DIS_OUT else min(64, image_size // 2)
    d_resl = [image_size // 2 ** (i + 1) for i in range(n_up)] + [4]

    if not deep:
        gen = dict(inm=g_in, out=g_out, up=[True] * n_up, resl=g_resl,
                   att=g_att)
        dis = dict(inm=[0] + d_out[:-1], out=d_out,
                   down=[True] * n_up + [False], resl=d_resl, att=d_att,
                   input_conv=False)
        return gen, dis

    gen = dict(inm=[], out=[], up=[], resl=[], att=64 if image_size in
               _GEN_ATT else g_att)
    for i, (m_in, m_out) in enumerate(zip(g_in, g_out)):
        gen['inm'] += [m_in, m_in]
        gen['out'] += [m_in, m_out]
        gen['up'] += [False, True]
        gen['resl'] += [g_resl[i] // 2, g_resl[i]]
    dis = dict(inm=[0], out=[d_out[0] // 2 or 1], down=[False],
               resl=[image_size], att=d_att, input_conv=True)
    prev = dis['out'][0]
    for i, m in enumerate(d_out[:-1]):
        dis['inm'] += [prev, m]
        dis['out'] += [m, m]
        dis['down'] += [True, False]
        dis['resl'] += [image_size // 2 ** (i + 1)] * 2
        prev = m
    return gen, dis


_xavier = get_initializer('xavier')


def SNDense(in_features, features, use_sn=True, use_bias=True, dtype=torch.float32,
            generator=None):
    '''flax Dense (xavier_normal kernel) under flax's spectral norm.'''
    return sn.SNDense(in_features, features, use_bias, dtype, generator, use_sn, _xavier)


def SNConv(in_ch, features, kernel_size=3, use_sn=True, use_bias=True, dtype=torch.float32,
           generator=None):
    '''flax Conv ('SAME', xavier_normal kernel) under flax's spectral norm.'''
    return sn.SNConv(in_ch, features, kernel_size, use_bias=use_bias, dtype=dtype,
                     generator=generator, use_sn=use_sn, weight_init=_xavier)


class ConditionalNorm(nn.Module):
    '''Affine-free norm, then z-conditional gain and bias:
    out = norm(x) * (1 - gain(z)) + bias(z).'''

    def __init__(self, channels, z_dim, use_sn=True, norm_name='bn', dtype=torch.float32,
                 generator=None):
        super().__init__()
        if norm_name not in ('bn', 'in'):
            raise ValueError(f'norm_name must be bn or in, got {norm_name!r}')
        self.bn = norm_name == 'bn'
        if self.bn:
            self.register_buffer('running_mean', torch.zeros(channels))
            self.register_buffer('running_var', torch.ones(channels))
        self.gain = SNDense(z_dim, channels, use_sn, dtype=dtype, generator=generator)
        self.bias = SNDense(z_dim, channels, use_sn, dtype=dtype, generator=generator)
        self.dtype = dtype

    def forward(self, x, z, train: bool = True):
        if self.bn:
            norm = batch_norm(x, None, None, self.running_mean, self.running_var, train,
                              dtype=self.dtype)
        else:
            norm = instance_norm(x, dtype=self.dtype)
        gain = self.gain(z, train)
        bias = self.bias(z, train)
        return norm * (1 - gain)[:, :, None, None] + bias[:, :, None, None]


def up2x(x):
    return F.interpolate(x, scale_factor=2, mode='nearest')


class GBlock(nn.Module):
    def __init__(self, in_ch, features, z_dim, upsample=True, use_sn=True, norm_name='bn',
                 act_name='relu', dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.upsample = upsample
        self.act_fn = get_activation(act_name)
        self.cn1 = ConditionalNorm(in_ch, z_dim, use_sn, norm_name, **kw)
        self.skip = (SNConv(in_ch, features, 1, use_sn, **kw)
                     if upsample or in_ch != features else None)
        self.conv1 = SNConv(in_ch, features, 3, use_sn, **kw)
        self.cn2 = ConditionalNorm(features, z_dim, use_sn, norm_name, **kw)
        self.conv2 = SNConv(features, features, 3, use_sn, **kw)

    def forward(self, x, z, train: bool = True):
        act = self.act_fn
        h = act(self.cn1(x, z, train))
        if self.upsample:
            h, x = up2x(h), up2x(x)
        if self.skip is not None:
            x = self.skip(x, train)
        h = self.conv1(h, train)
        h = act(self.cn2(h, z, train))
        return self.conv2(h, train) + x


class GBlockDeep(nn.Module):
    '''BigGAN-deep G block: CN-act-1x1 -> CN-act -> channel-drop skip -> up
    -> 3x3, CN-act, 3x3 -> CN-act -> 1x1 out. The skip has no conv: it keeps
    the first `features` channels.'''

    def __init__(self, in_ch, features, z_dim, upsample=True, use_sn=True, channel_ratio=4,
                 norm_name='bn', act_name='relu', dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        mid = in_ch // channel_ratio
        self.upsample, self.features = upsample, features
        self.act_fn = get_activation(act_name)
        self.cn1 = ConditionalNorm(in_ch, z_dim, use_sn, norm_name, **kw)
        self.conv1 = SNConv(in_ch, mid, 1, use_sn, **kw)
        self.cn2 = ConditionalNorm(mid, z_dim, use_sn, norm_name, **kw)
        self.conv2 = SNConv(mid, mid, 3, use_sn, **kw)
        self.cn3 = ConditionalNorm(mid, z_dim, use_sn, norm_name, **kw)
        self.conv3 = SNConv(mid, mid, 3, use_sn, **kw)
        self.cn4 = ConditionalNorm(mid, z_dim, use_sn, norm_name, **kw)
        self.conv4 = SNConv(mid, features, 1, use_sn, **kw)

    def forward(self, x, z, train: bool = True):
        act = self.act_fn
        h = self.conv1(act(self.cn1(x, z, train)), train)
        h = act(self.cn2(h, z, train))
        if x.shape[1] != self.features:
            x = x[:, :self.features]
        if self.upsample:
            h, x = up2x(h), up2x(x)
        h = act(self.cn3(self.conv2(h, train), z, train))
        h = act(self.cn4(self.conv3(h, train), z, train))
        return self.conv4(h, train) + x


class DBlock(nn.Module):
    def __init__(self, in_ch, features, downsample=True, use_sn=True, act_name='relu',
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.downsample = downsample
        self.act_fn = get_activation(act_name)
        self.conv1 = SNConv(in_ch, features, 3, use_sn, **kw)
        self.conv2 = SNConv(features, features, 3, use_sn, **kw)
        self.skip = SNConv(in_ch, features, 1, use_sn, **kw) if in_ch != features else None

    def forward(self, x, train: bool = True):
        act = self.act_fn
        h = self.conv2(act(self.conv1(act(x), train)), train)
        if self.downsample:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        if self.skip is not None:
            x = self.skip(x, train)
        return h + x


class DBlockDeep(nn.Module):
    '''BigGAN-deep D block: act-1x1 -> act-3x3 -> act-3x3 -> act -> down ->
    1x1 out; the skip widens by concatenating [x, conv1x1(x)].'''

    def __init__(self, in_ch, features, downsample=True, use_sn=True, channel_ratio=4,
                 act_name='relu', dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        mid = features // channel_ratio
        self.downsample = downsample
        self.act_fn = get_activation(act_name)
        self.conv1 = SNConv(in_ch, mid, 1, use_sn, **kw)
        self.conv2 = SNConv(mid, mid, 3, use_sn, **kw)
        self.conv3 = SNConv(mid, mid, 3, use_sn, **kw)
        self.conv4 = SNConv(mid, features, 1, use_sn, **kw)
        self.widen = (SNConv(in_ch, features - in_ch, 1, use_sn, **kw)
                      if in_ch != features else None)

    def forward(self, x, train: bool = True):
        act = self.act_fn
        h = self.conv1(act(x), train)
        h = self.conv2(act(h), train)
        h = act(self.conv3(act(h), train))
        if self.downsample:
            h, x = F.avg_pool2d(h, 2), F.avg_pool2d(x, 2)
        h = self.conv4(h, train)
        if self.widen is not None:
            x = torch.cat([x, self.widen(x, train)], dim=1)
        return h + x


def _positions(x):
    '''NCHW [B, C, H, W] -> [B, H * W, C], positions row-major.'''
    return x.flatten(2).transpose(1, 2)


class SelfAttention(nn.Module):
    '''SAGAN non-local block with 2x2 max-pooled keys and values.'''

    def __init__(self, channels, use_sn=True, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(use_sn=use_sn, use_bias=False, dtype=dtype, generator=generator)
        C = channels
        self.theta = SNConv(C, C // 8, 1, **kw)
        self.phi = SNConv(C, C // 8, 1, **kw)
        self.g = SNConv(C, C // 2, 1, **kw)
        self.out = SNConv(C // 2, C, 1, **kw)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x, train: bool = True):
        B, C, H, W = x.shape
        theta = _positions(self.theta(x, train))
        phi = _positions(F.max_pool2d(self.phi(x, train), 2))
        g = _positions(F.max_pool2d(self.g(x, train), 2))
        beta = torch.softmax(torch.bmm(theta.float(), phi.float().transpose(1, 2)), dim=-1)
        out = torch.bmm(beta.to(g.dtype), g)                              # [B, HW, C/2]
        out = out.transpose(1, 2).reshape(B, C // 2, H, W)
        return self.gamma.to(x.dtype) * self.out(out, train) + x


class SqueezeExcitation(nn.Module):
    '''SE channel gating: spatial mean -> dense C/16 -> relu -> dense C ->
    sigmoid (float32), bias-free spectral-normalized dense layers.'''

    def __init__(self, channels, use_sn=True, reduction=16, dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(use_sn=use_sn, use_bias=False, dtype=dtype, generator=generator)
        self.fc1 = SNDense(channels, max(1, channels // reduction), **kw)
        self.fc2 = SNDense(max(1, channels // reduction), channels, **kw)

    def forward(self, x, train: bool = True):
        s = F.relu(self.fc1(x.mean(dim=(2, 3)), train))
        s = torch.sigmoid(self.fc2(s, train).float())
        return x * s[:, :, None, None].to(x.dtype)


class LambdaLayer(nn.Module):
    '''LambdaNetworks content and position lambdas (`att_name='ll'`) at a
    `resolution` x `resolution` input; `pos_emb` [n, n, keys, u], n = H * W,
    N(0, 1) init. The norms on q and v have scale and bias.'''

    def __init__(self, channels, resolution, use_sn=True, keys=16, heads=4, u=1,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(use_sn=use_sn, use_bias=False, dtype=dtype, generator=generator)
        n, vs = resolution ** 2, channels // heads
        self.keys, self.heads, self.u, self.vs = keys, heads, u, vs
        self.q = SNConv(channels, keys * heads, 1, **kw)
        self.k = SNConv(channels, keys * u, 1, **kw)
        self.v = SNConv(channels, vs * u, 1, **kw)
        self.q_bn = BatchNorm(keys * heads, dtype=dtype)
        self.v_bn = BatchNorm(vs * u, dtype=dtype)
        self.pos_emb = nn.Parameter(torch.randn((n, n, keys, u), generator=generator))

    def forward(self, x, train: bool = True):
        B, C, H, W = x.shape
        n = H * W
        q = _positions(self.q_bn(self.q(x, train), train)).reshape(B, n, self.heads, self.keys)
        k = _positions(self.k(x, train)).reshape(B, n, self.u, self.keys)
        v = _positions(self.v_bn(self.v(x, train), train)).reshape(B, n, self.u, self.vs)
        k = torch.softmax(k.float(), dim=1).to(v.dtype)
        lam_c = torch.einsum('bmuk,bmuv->bkv', k, v)
        y_c = torch.einsum('bnhk,bkv->bnhv', q, lam_c)
        lam_p = torch.einsum('nmku,bmuv->bnkv', self.pos_emb.to(v.dtype), v)
        y_p = torch.einsum('bnhk,bnkv->bnhv', q, lam_p)
        y = (y_c + y_p).reshape(B, H, W, self.heads * self.vs)
        return y.permute(0, 3, 1, 2)


def make_attention(att_name, channels, resolution, use_sn, dtype, generator):
    '''The JAX `make_attention` dispatch: 'sa', 'se' or 'll'.'''
    assert att_name in ('sa', 'll', 'se'), att_name
    kw = dict(use_sn=use_sn, dtype=dtype, generator=generator)
    if att_name == 'll':
        return LambdaLayer(channels, resolution, **kw)
    if att_name == 'se':
        return SqueezeExcitation(channels, **kw)
    return SelfAttention(channels, **kw)


class Generator(nn.Module):
    '''z [B, z_dim] -> images [B, 3, S, S] float32 in [-1, 1].'''

    def __init__(self, image_size=128, z_dim=120, channels=64, deep=False, use_sn=True,
                 use_attention=True, att_name='sa', norm_name='bn', act_name='relu',
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        gen, _ = _arch(image_size, deep)
        ch = channels
        self.z_dim, self.dtype = z_dim, dtype
        self.act_fn = get_activation(act_name)
        self.in_ch = gen['inm'][0] * ch
        self.fc = SNDense(z_dim, 4 * 4 * self.in_ch, use_sn, **kw)
        block = GBlockDeep if deep else GBlock
        blocks, in_ch, self.att_index, self.attention = [], self.in_ch, None, None
        for i, (out_mul, up, resl) in enumerate(zip(gen['out'], gen['up'], gen['resl'])):
            blocks.append(block(in_ch, out_mul * ch, z_dim, up, use_sn, norm_name=norm_name,
                                act_name=act_name, **kw))
            in_ch = out_mul * ch
            if use_attention and resl == gen['att'] and self.att_index is None:
                self.att_index = i
                self.attention = make_attention(att_name, in_ch, resl, use_sn, **kw)
        self.blocks = nn.ModuleList(blocks)
        self.bn = BatchNorm(in_ch, dtype=dtype)
        self.out = SNConv(in_ch, 3, 3, use_sn, **kw)

    def forward(self, z, train: bool = True):
        x = self.fc(z.to(self.dtype), train)
        x = x.reshape(x.shape[0], 4, 4, self.in_ch).permute(0, 3, 1, 2)     # NHWC order
        for i, block in enumerate(self.blocks):
            x = block(x, z, train)
            if i == self.att_index:
                x = self.attention(x, train)
        x = self.act_fn(self.bn(x, train))
        return torch.tanh(self.out(x, train).float())


class Discriminator(nn.Module):
    '''images [B, 3, S, S] -> logits [B, 1] float32. The deep D's first
    entry of `blocks` is its plain 3x3 input conv.'''

    def __init__(self, image_size=128, channels=64, deep=False, use_sn=True,
                 use_attention=True, att_name='sa', act_name='relu', dtype=torch.float32,
                 generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        _, dis = _arch(image_size, deep)
        ch = channels
        self.dtype = dtype
        self.act_fn = get_activation(act_name)
        block = DBlockDeep if deep else DBlock
        n_blocks = len(dis['out'])
        blocks, in_ch, self.att_index, self.attention = [], 3, None, None
        for i, (out_mul, down, resl) in enumerate(zip(dis['out'], dis['down'], dis['resl'])):
            if i == 0 and dis['input_conv']:
                blocks.append(SNConv(in_ch, out_mul * ch, 3, use_sn, **kw))
            else:
                blocks.append(block(in_ch, out_mul * ch, down, use_sn, act_name=act_name,
                                    **kw))
            in_ch = out_mul * ch
            nxt = dis['resl'][i + 1] if i + 1 < n_blocks else -1
            if (use_attention and resl == dis['att'] and nxt != dis['att']
                    and self.att_index is None):
                self.att_index = i
                self.attention = make_attention(att_name, in_ch, resl, use_sn, **kw)
        self.blocks = nn.ModuleList(blocks)
        self.fc = SNDense(in_ch, 1, use_sn, **kw)

    def forward(self, x, train: bool = True):
        x = x.to(self.dtype)
        for i, block in enumerate(self.blocks):
            x = block(x, train)
            if i == self.att_index:
                x = self.attention(x, train)
        x = self.act_fn(x).sum(dim=(2, 3))              # global sum pool
        return self.fc(x, train).float()
