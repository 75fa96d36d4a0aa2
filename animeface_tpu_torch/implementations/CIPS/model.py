'''CIPS (conditionally-independent pixel synthesis) in PyTorch.

Counterpart of `animeface_tpu/implementations/CIPS/model.py`, class for
class: `ModulatedFC`, `StyleLayer`, `SynthesisInput` and `Generator`; D is
the port's StyleGAN3 `Discriminator`, re-exported as the JAX module does.
What is kept from the JAX package:
  * the layout [B, S^2, C]: every pixel runs the same style-modulated MLP,
    each layer one batched matmul of the map with a per-sample weight
    [B, in, out];
  * the per-module dtype: the mapping and the affines in float32 (the
    port's StyleGAN3 `Linear`), the products and the StyleLayers in
    `dtype`, the RGB sum in float32;
  * modulated weights in the JAX layout [in, out], so `convert.py` carries
    them over unchanged;
  * `w_avg` as a buffer (the StyleGAN3 `Mapping`), updated in place by a
    forward with `train=True`.
Every `bias_act` with a bias (the StyleLayers' lrelu, the mapping and the
affines) goes through the ops registry: under impl 'cuda', at the recipe's
widths, each such call is in the kernel's scope. `forward` returns NCHW
images, as the port's other generators do.
'''

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from animeface_tpu_torch.ops import bias_act
from animeface_tpu_torch.implementations.StyleGAN3.model import (  # noqa: F401
    Discriminator, Linear, Mapping, _normal)


class ModulatedFC(nn.Module):
    '''out[b] = x[b] @ (W * scale * s[b] / demod); x [B, S^2, in].'''

    def __init__(self, in_features, style_dim, features, demod=True, gain=1.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.affine = Linear(style_dim, in_features, bias_init=1.0, generator=generator)
        self.weight = _normal((in_features, features), generator)
        self.scale = gain / np.sqrt(in_features)
        self.demod = demod
        self.dtype = dtype

    def forward(self, x, style):
        s = self.affine(style.float())                              # [B, in]
        w = (self.weight * self.scale)[None] * s[:, :, None]        # [B, in, out]
        if self.demod:
            w = w * torch.rsqrt((w * w).sum(dim=1, keepdim=True) + 1e-8)
        return torch.bmm(x.to(self.dtype), w.to(self.dtype))


class StyleLayer(nn.Module):
    '''ModulatedFC -> bias_act(lrelu) along the channel axis. The f32 bias
    goes in as it is: both implementations round it to x's dtype.'''

    def __init__(self, in_features, style_dim, features, dtype=torch.float32, generator=None):
        super().__init__()
        self.fc = ModulatedFC(in_features, style_dim, features, True, dtype=dtype,
                              generator=generator)
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x, style):
        x = self.fc(x, style)
        return bias_act(x, self.bias, dim=-1, act='lrelu')


class SynthesisInput(nn.Module):
    '''sin(coords @ B) Fourier features, then the learned per-pixel
    constants, along the channel axis: [B, S^2, 2 * channels].'''

    def __init__(self, channels, size, dtype=torch.float32, generator=None):
        super().__init__()
        self.size = size
        self.b = Linear(2, channels, use_bias=False, generator=generator)
        self.constant = _normal((1, size * size, channels), generator)
        self.dtype = dtype

    def forward(self, batch: int):
        S = self.size
        ys = (2 * torch.arange(S, device=self.constant.device) + 1) / S - 1
        gy, gx = torch.meshgrid(ys, ys, indexing='ij')
        coords = torch.stack([gx, gy], dim=-1).reshape(1, S * S, 2)
        ff = torch.sin(self.b(coords)).expand(batch, -1, -1)
        const = self.constant.expand(batch, -1, -1)
        return torch.cat([ff, const], dim=-1).to(self.dtype)


class Generator(nn.Module):
    '''Mapping, the synthesis input, 1 + num_layers StyleLayers and an RGB
    ModulatedFC after every second one, summed. forward(z, truncation_psi,
    train) -> [B, image_channels, S, S] float32.'''

    def __init__(self, image_size=128, latent_dim=512, style_dim=512, num_layers=14,
                 channels=32, max_channels=512, image_channels=3, map_num_layers=4,
                 pixel_norm=True, ema_decay=0.998, dtype=torch.float32, generator=None):
        super().__init__()
        assert num_layers % 2 == 0
        self.image_size = image_size
        self.image_channels = image_channels
        self.latent_dim = latent_dim
        kw = dict(dtype=dtype, generator=generator)
        self.map = Mapping(latent_dim, style_dim, map_num_layers, pixel_norm, ema_decay,
                           generator=generator)
        c = channels * 2 ** num_layers
        och = min(max_channels, c)
        self.input = SynthesisInput(och, image_size, **kw)
        layers = [StyleLayer(2 * och, style_dim, och, **kw)]
        to_rgbs = []
        for _ in range(num_layers // 2):
            c //= 2
            ich, och = och, min(max_channels, c)
            layers += [StyleLayer(ich, style_dim, och, **kw), StyleLayer(och, style_dim, och, **kw)]
            to_rgbs.append(ModulatedFC(och, style_dim, image_channels, demod=False, **kw))
        self.layers = nn.ModuleList(layers)
        self.to_rgbs = nn.ModuleList(to_rgbs)

    def moment_buffers(self):
        '''The buffers a forward with `train=True` updates: w_avg.'''
        return [self.map.w_avg]

    def forward(self, z, truncation_psi: float = 1.0, train: bool = False):
        w = self.map(z, truncation_psi, train=train)
        B, S = z.shape[0], self.image_size
        h = self.layers[0](self.input(B), w)
        image = torch.zeros((B, S * S, self.image_channels), device=z.device)
        for i, to_rgb in enumerate(self.to_rgbs):
            h = self.layers[2 * i + 2](self.layers[2 * i + 1](h, w), w)
            image = image + to_rgb(h, w).float()
        return image.reshape(B, S, S, self.image_channels).permute(0, 3, 1, 2)
