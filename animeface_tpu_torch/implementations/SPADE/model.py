'''SPADE in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/SPADE/model.py`:
  * `Norm`: the norm without affine terms, 'bn' flax's BatchNorm (momentum
    0.9, eps 1e-5, running statistics used when `train=False`), 'in'
    flax's `GroupNorm(group_size=1)` (eps 1e-6);
  * `sn_conv`: flax's spectral norm (`nnutils/spectral_norm.py:SNConv`, one
    power iteration a call, u stored with `train=True`) around a conv with
    padding k // 2, xavier-normal kernels and zero biases, or the plain
    conv without it;
  * `SPADE`: norm(x) * gamma(seg) + beta(seg), the segmentation map
    resized to x's size by nearest neighbour (JAX's `'nearest'`, which is
    PyTorch's `'nearest-exact'`), a hidden 3x3 conv and act, then the gamma
    and beta 3x3 convs; these three convs never take spectral norm;
  * `SPADEResBlock`: (SPADE, act, conv) `num_conv` times, and a (SPADE,
    act, conv) shortcut where the width changes;
  * `Generator`: a dense layer from z to a 4x4 map (flax's NHWC reshape),
    log2(image_size) - 2 residual blocks halving the width (from
    channels * 2^n, at most `max_channels`), each followed by a nearest
    2x upsampling, then tanh of a 3x3 conv in float32;
  * `Encoder`: a 4x4 stride-2 conv (padding 2), norm and act, then such
    convs doubling the width until the size count halves down to
    `target_resl` (the maps, 65 -> 33 -> ... at 128px, are one larger:
    the padding), the map flattened in H, W, C order into the mu and
    logvar dense layers (float32); z = mu + exp(logvar / 2) * eps, eps an
    input.
D is SRGAN's (`SRGAN/model.py:Discriminator`). The layers sit in lists
in flax's creation order (`convs`, `spades`, `norms`, `blocks`), which
`convert.py:convert_spade_*` fills.
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.implementations.SRGAN.model import Discriminator  # noqa: F401
from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.initialize import get_initializer
from animeface_tpu_torch.nnutils.module.layers import get_activation
from animeface_tpu_torch.nnutils.module.linen import Dense, GroupNorm, f32
from animeface_tpu_torch.nnutils.spectral_norm import SNConv


def sn_conv(in_ch, features, kernel_size=3, stride=1, use_sn=True, use_bias=True,
            dtype=torch.float32, generator=None):
    '''JAX `SNConv`: forward(x, train).'''
    return SNConv(in_ch, features, kernel_size, stride, kernel_size // 2, use_bias, dtype,
                  generator, use_sn, get_initializer('xavier'))


class Norm(nn.Module):
    def __init__(self, name, channels, dtype=torch.float32):
        super().__init__()
        if name == 'bn':
            self.norm = BatchNorm(channels, dtype=dtype, affine=False)
        elif name == 'in':
            self.norm = GroupNorm(channels, channels, affine=False, dtype=dtype)
        else:
            raise ValueError(f'norm {name!r}')

    def forward(self, x, train: bool = True):
        return self.norm(x, train) if isinstance(self.norm, BatchNorm) else self.norm(x)


class SPADE(nn.Module):
    def __init__(self, channels, seg_channels, hidden_channels=128, norm_name='bn',
                 act_name='relu', use_bias=True, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(use_sn=False, use_bias=use_bias, dtype=dtype, generator=generator)
        self.norm = Norm(norm_name, channels, dtype)
        self.convs = nn.ModuleList([sn_conv(seg_channels, hidden_channels, **kw),
                                    sn_conv(hidden_channels, channels, **kw),
                                    sn_conv(hidden_channels, channels, **kw)])
        self.act = get_activation(act_name)
        self.dtype = dtype

    def forward(self, x, seg, train: bool = True):
        norm = self.norm(x, train)
        seg = F.interpolate(seg, size=x.shape[-2:], mode='nearest-exact').to(x.dtype)
        h = self.act(self.convs[0](seg, train))
        return self.convs[1](h, train) * norm + self.convs[2](h, train)


class SPADEResBlock(nn.Module):
    def __init__(self, in_channels, features, seg_channels, num_conv=2, hidden_channels=128,
                 norm_name='bn', act_name='lrelu', use_sn=True, use_bias=True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        spade = dict(hidden_channels=hidden_channels, norm_name=norm_name, act_name=act_name,
                     use_bias=use_bias, dtype=dtype, generator=generator)
        conv = dict(use_sn=use_sn, use_bias=use_bias, dtype=dtype, generator=generator)
        spades, convs, ch = [], [], in_channels
        for _ in range(num_conv):
            spades.append(SPADE(ch, seg_channels, **spade))
            convs.append(sn_conv(ch, features, **conv))
            ch = features
        self.shortcut = in_channels != features
        if self.shortcut:
            spades.append(SPADE(in_channels, seg_channels, **spade))
            convs.append(sn_conv(in_channels, features, **conv))
        self.spades, self.convs = nn.ModuleList(spades), nn.ModuleList(convs)
        self.act = get_activation(act_name)
        self.num_conv = num_conv

    def forward(self, x, seg, train: bool = True):
        h = x
        for spade, conv in zip(self.spades[:self.num_conv], self.convs[:self.num_conv]):
            h = conv(self.act(spade(h, seg, train)), train)
        if self.shortcut:
            x = self.convs[-1](self.act(self.spades[-1](x, seg, train)), train)
        return x + h


class Generator(nn.Module):
    def __init__(self, image_size=128, z_dim=256, in_channels=1, out_channels=3, channels=32,
                 max_channels=1024, block_num_conv=2, spade_hidden_channels=128,
                 norm_name='bn', act_name='lrelu', use_sn=True, use_bias=True,
                 dtype=torch.float32, generator=None):
        super().__init__()
        num_ups = int(np.log2(image_size) - 2)
        c = channels * 2 ** num_ups
        och = min(max_channels, c)
        self.dense = Dense(z_dim, och * 16, use_bias=use_bias, dtype=dtype,
                           init=get_initializer('xavier'), generator=generator)
        blocks = []
        for _ in range(num_ups):
            c //= 2
            ich, och = och, min(max_channels, c)
            blocks.append(SPADEResBlock(ich, och, in_channels, block_num_conv,
                                        spade_hidden_channels, norm_name, act_name, use_sn,
                                        use_bias, dtype, generator))
        self.blocks = nn.ModuleList(blocks)
        self.out = sn_conv(och, out_channels, 3, 1, use_sn, use_bias, dtype, generator)
        self.z_dim, self.dtype = z_dim, dtype

    def forward(self, z, seg, train: bool = True):
        x = self.dense(z.to(self.dtype))
        x = x.reshape(x.shape[0], 4, 4, -1).permute(0, 3, 1, 2)
        for block in self.blocks:
            x = F.interpolate(block(x, seg, train), scale_factor=2, mode='nearest')
        return torch.tanh(f32(self.out(x, train)))


class Encoder(nn.Module):
    def __init__(self, image_size=128, z_dim=256, target_resl=4, channels=32, max_channels=512,
                 norm_name='bn', act_name='lrelu', use_sn=False, use_bias=True,
                 in_channels=3, dtype=torch.float32, generator=None):
        super().__init__()
        conv = dict(use_sn=use_sn, use_bias=use_bias, dtype=dtype, generator=generator)
        c = och = channels
        size, side = image_size // 2, image_size // 2 + 1         # padding 2: one larger
        convs, norms = [sn_conv(in_channels, c, 4, 2, **conv)], [Norm(norm_name, c, dtype)]
        while size > target_resl:
            size //= 2
            side = side // 2 + 1
            c *= 2
            ich, och = och, min(max_channels, c)
            convs.append(sn_conv(ich, och, 4, 2, **conv))
            norms.append(Norm(norm_name, och, dtype))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.mu = Dense(side * side * och, z_dim, generator=generator)
        self.logvar = Dense(side * side * och, z_dim, generator=generator)
        self.act = get_activation(act_name)
        self.dtype = dtype

    def forward(self, x, eps, train: bool = True):
        '''(z, mu, logvar) of images x, with the draw eps [B, z_dim].'''
        x = x.to(self.dtype)
        for conv, norm in zip(self.convs, self.norms):
            x = self.act(norm(conv(x, train), train))
        x = f32(x.permute(0, 2, 3, 1).flatten(1))
        mu, logvar = self.mu(x), self.logvar(x)
        return mu + torch.exp(0.5 * logvar) * eps.to(mu.dtype), mu, logvar
