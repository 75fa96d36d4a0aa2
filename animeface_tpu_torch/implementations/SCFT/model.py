'''SCFT in PyTorch, NCHW: reference-based sketch colorization.

Counterpart of `animeface_tpu/implementations/SCFT/model.py`:
  * `ConvBlock`: a conv (flax's spectral norm, `nnutils/spectral_norm.py`,
    unless `sn` is off; lecun-normal kernels, zero biases), a norm
    (`get_normalization`) and an act;
  * `ResBlock`: `num_conv - 1` ConvBlocks, a conv and a norm, then
    act(x + h) / sqrt(2);
  * `Encoder`: `layer_per_resl` ConvBlocks at full size, then as many at
    each of log2(image_size / bottom_width) halvings (the first of each at
    stride 2) doubling the width; every block's output average-pooled to
    the bottom grid and concatenated (992 channels at 128px and the
    defaults), with the list of outputs;
  * `SCFT`: queries from the sketch's bottom features, keys and values
    from the reference's (dense layers over the channels, with spectral
    norm, without bias unless `scft_bias`); the logits in float32, softmax
    over the keys BEFORE the division by sqrt(C), the attended values added
    to the sketch's features; q and k returned in float32 for the triplet
    loss;
  * `Generator`: both encoders, SCFT, `num_res_blocks` ResBlocks, and the
    zip decoder: for each of the features (the sketch encoder's and the
    residual output, last first) x = concat(x, feature), upsampled
    bilinearly 2x (half-pixel centres) at the last stage of each
    resolution, then a ConvBlock; the last stage a conv to RGB and tanh in
    float32;
  * `Discriminator`: the patch D on (sketch ‖ image): 4x4 stride-2 VALID
    convs with norm and act (none after the first), a 4x4 VALID conv to
    one logit a patch (128 -> 63 -> 30 -> 14 -> 6 -> 3 at 128px; below
    128px the last conv's input is smaller than its kernel and PyTorch
    raises where JAX asserts), logits in float32 and the activations.
The layers sit in lists in flax's creation order (`blocks`, `dec`,
`convs`, `norms`), which `convert.py:convert_scft_*` fills.
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.nnutils.batchnorm import BatchNorm
from animeface_tpu_torch.nnutils.module.layers import get_activation, get_normalization
from animeface_tpu_torch.nnutils.module.linen import f32, lecun_normal
from animeface_tpu_torch.nnutils.spectral_norm import SNConv, SNDense


def _norm(norm, x, train):
    return norm(x, train) if isinstance(norm, BatchNorm) else norm(x)


def _conv(in_ch, features, kernel_size, stride, padding, sn, use_bias, dtype, generator):
    return SNConv(in_ch, features, kernel_size, stride, padding, use_bias, dtype, generator, sn,
                  lecun_normal)


class ConvBlock(nn.Module):
    def __init__(self, in_ch, features, kernel_size=3, stride=1, padding=1, sn=True,
                 use_bias=True, norm_name='in', act_name='lrelu', dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.conv = _conv(in_ch, features, kernel_size, stride, padding, sn, use_bias, dtype,
                          generator)
        self.norm = get_normalization(norm_name, features, dtype=dtype)
        self.act = get_activation(act_name)

    def forward(self, x, train: bool = True):
        return self.act(_norm(self.norm, self.conv(x, train), train))


class ResBlock(nn.Module):
    def __init__(self, features, num_conv=2, sn=True, use_bias=True, norm_name='in',
                 act_name='lrelu', dtype=torch.float32, generator=None):
        super().__init__()
        self.blocks = nn.ModuleList(ConvBlock(features, features, 3, 1, 1, sn, use_bias,
                                              norm_name, act_name, dtype, generator)
                                    for _ in range(num_conv - 1))
        self.conv = _conv(features, features, 3, 1, 1, sn, use_bias, dtype, generator)
        self.norm = get_normalization(norm_name, features, dtype=dtype)
        self.act = get_activation(act_name)

    def forward(self, x, train: bool = True):
        h = x
        for block in self.blocks:
            h = block(h, train)
        h = _norm(self.norm, self.conv(h, train), train)
        return self.act(x + h) / np.sqrt(2)


class Encoder(nn.Module):
    def __init__(self, in_channels=3, image_size=128, bottom_width=8, channels=16,
                 layer_per_resl=2, sn=True, use_bias=True, norm_name='in', act_name='lrelu',
                 dtype=torch.float32, generator=None):
        super().__init__()
        num_down = int(np.log2(image_size) - np.log2(bottom_width))
        common = (sn, use_bias, norm_name, act_name, dtype, generator)
        blocks, c, ch = [], channels, in_channels
        for _ in range(layer_per_resl):
            blocks.append(ConvBlock(ch, c, 3, 1, 1, *common))
            ch = c
        for _ in range(num_down):
            c *= 2
            for i in range(layer_per_resl):
                blocks.append(ConvBlock(ch, c, 3, 2 if i == 0 else 1, 1, *common))
                ch = c
        self.blocks = nn.ModuleList(blocks)
        self.feature_channels = [b.conv.weight.shape[0] for b in blocks]
        self.bottom_width, self.dtype = bottom_width, dtype

    def forward(self, x, train: bool = True):
        feats = []
        x = x.to(self.dtype)
        for block in self.blocks:
            x = block(x, train)
            feats.append(x)
        pooled = []
        for f in feats:
            k = f.shape[-1] // self.bottom_width
            pooled.append(F.avg_pool2d(f, k, k) if k > 1 else f)
        return torch.cat(pooled, dim=1), feats


class SCFT(nn.Module):
    def __init__(self, channels, sn=True, use_bias=False, dtype=torch.float32, generator=None):
        super().__init__()
        self.kv = SNDense(channels, 2 * channels, use_bias, dtype, generator, sn, lecun_normal)
        self.q = SNDense(channels, channels, use_bias, dtype, generator, sn, lecun_normal)

    def forward(self, ref, sketch, train: bool = True):
        B, C, H, W = ref.shape
        r = ref.flatten(2).transpose(1, 2)                   # [B, HW, C]
        s = sketch.flatten(2).transpose(1, 2)
        k, v = self.kv(r, train).chunk(2, dim=-1)
        q = self.q(s, train)
        attn = torch.softmax(torch.einsum('bqc,bkc->bqk', f32(q), f32(k)), dim=-1) / np.sqrt(C)
        heat = torch.einsum('bqk,bkc->bqc', attn.to(v.dtype), v)
        out = (s + heat).transpose(1, 2).reshape(B, C, H, W)
        return out, (f32(q), f32(k))


class Generator(nn.Module):
    def __init__(self, image_size=128, in_channels=1, ref_channels=3, bottom_width=8,
                 enc_channels=16, layer_per_resl=2, num_res_blocks=7, sn=True, use_bias=True,
                 scft_bias=False, norm_name='in', act_name='lrelu', dtype=torch.float32,
                 generator=None):
        super().__init__()
        num_ups = int(np.log2(image_size) - np.log2(bottom_width))
        common = (sn, use_bias, norm_name, act_name, dtype, generator)
        enc = (image_size, bottom_width, enc_channels, layer_per_resl, *common)
        self.ref_encoder = Encoder(ref_channels, *enc)
        self.sketch_encoder = Encoder(in_channels, *enc)
        feats = self.sketch_encoder.feature_channels
        C = sum(feats)
        self.scft = SCFT(C, sn, scft_bias, dtype, generator)
        self.blocks = nn.ModuleList(ResBlock(C, 2, *common) for _ in range(num_res_blocks))
        # the decoder's stages (out, upsample), each on concat(x, its feature)
        c = enc_channels * 2 ** num_ups
        stages = [(c, False)]
        for _ in range(num_ups):
            c //= 2
            stages += [(c, i == layer_per_resl - 1) for i in range(layer_per_resl)]
        stages.append((c, False))
        dec, ch = [], C
        for (och, _), feat in zip(stages, [C, *feats[::-1]]):
            dec.append(ConvBlock(ch + feat, och, 3, 1, 1, *common))
            ch = och
        self.dec = nn.ModuleList(dec)
        self.ups = [up for _, up in stages]
        self.out = _conv(ch + feats[0], ref_channels, 3, 1, 1, sn, use_bias, dtype, generator)

    def forward(self, sketch, ref, return_qk: bool = False, train: bool = True):
        ref_feat, _ = self.ref_encoder(ref, train)
        sk_feat, sk_feats = self.sketch_encoder(sketch, train)
        res, qk = self.scft(ref_feat, sk_feat, train)
        for block in self.blocks:
            res = block(res, train)
        dec_feats = (sk_feats + [res])[::-1]
        x = sk_feat
        for block, up, feat in zip(self.dec, self.ups, dec_feats):
            x = torch.cat([x, feat.to(x.dtype)], dim=1)
            if up:
                x = F.interpolate(x, scale_factor=2, mode='bilinear', align_corners=False)
            x = block(x, train)
        x = torch.cat([x, dec_feats[-1].to(x.dtype)], dim=1)
        out = torch.tanh(f32(self.out(x, train)))
        return (out, qk) if return_qk else out


class Discriminator(nn.Module):
    def __init__(self, in_channels=4, num_layers=3, channels=32, sn=True, use_bias=True,
                 norm_name='in', act_name='lrelu', dtype=torch.float32, generator=None):
        super().__init__()
        c = channels
        convs = [_conv(in_channels, c, 4, 2, 'VALID', sn, use_bias, dtype, generator)]
        norms = []
        for _ in range(num_layers):
            convs.append(_conv(c, 2 * c, 4, 2, 'VALID', sn, use_bias, dtype, generator))
            c *= 2
            norms.append(get_normalization(norm_name, c, dtype=dtype))
        convs.append(_conv(c, 1, 4, 1, 'VALID', sn, use_bias, dtype, generator))
        self.convs, self.norms = nn.ModuleList(convs), nn.ModuleList(norms)
        self.act = get_activation(act_name)
        self.dtype = dtype

    def forward(self, x, train: bool = True):
        x = self.act(self.convs[0](x.to(self.dtype), train))
        feats = [x]
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = self.act(_norm(norm, conv(x, train), train))
            feats.append(x)
        return f32(self.convs[-1](x, train)), feats
