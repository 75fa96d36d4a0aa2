'''StyleGAN3 (alias-free G, binomial-filtered residual D) in PyTorch, NCHW.

Counterpart of `animeface_tpu/implementations/StyleGAN3/model.py`, class for
class. What is kept from the JAX package:
  * per-layer FIR filters designed with scipy on the host when a layer is
    built (`design_filter`, `get_layer_params`), held as non-persistent
    buffers;
  * the factorized modulated conv (input scale, shared-weight conv that
    grows the map by k - 1, demodulation scale), the affine and the
    demodulation in float32;
  * an explicit compute `dtype` per module: convs, the synthesis input's
    projection and the filtered_lrelu chain in it; mappings, affines and
    D's two dense layers in float32; no autocast;
  * the JAX 'moments' collection becomes buffers: `magnitude_ema` of each
    layer and `w_avg` of the mapping, updated in place by a forward with
    `train=True`, and `freqs`/`phases` of the synthesis input. A training
    step that needs the pre-step moments snapshots and restores them
    (`Generator.moment_buffers`);
  * the JAX `flrelu_memory` field: how each layer's `filtered_lrelu` keeps
    what its backward needs ('pack' by default, 'store' or 'remat'; the
    three give the same values).

`convert.py` maps the JAX package's parameters and moments onto these
modules.
'''

from __future__ import annotations

import math

import numpy as np
import scipy.signal
import scipy.special
import torch
import torch.nn.functional as F
from torch import nn

from animeface_tpu_torch.ops import bias_act, conv2d_resample, filtered_lrelu


def _normal(shape, generator):
    return nn.Parameter(torch.randn(shape, generator=generator))


class Linear(nn.Module):
    '''Dense with equalized learning rate and bias_act; weight [out, in].'''

    def __init__(self, in_features, features, use_bias=True, act_name='linear',
                 gain=1.0, weight_init_zero=False, bias_init=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.weight = (nn.Parameter(torch.zeros(features, in_features)) if weight_init_zero
                       else _normal((features, in_features), generator))
        self.bias = None
        if use_bias:
            bias = (torch.zeros(features) if bias_init is None
                    else torch.as_tensor(np.broadcast_to(bias_init, (features,)).copy(),
                                         dtype=torch.float32))
            self.bias = nn.Parameter(bias)
        self.scale = gain / np.sqrt(in_features)
        self.act_name = act_name
        self.dtype = dtype

    def forward(self, x):
        y = F.linear(x.to(self.dtype), (self.weight * self.scale).to(self.dtype))
        b = None if self.bias is None else self.bias.to(y.dtype)
        return bias_act(y, b, act=self.act_name)


def design_filter(numtaps, cutoff, width, fs, radial=False):
    '''Lowpass FIR: Kaiser-windowed firwin, or the jinc-based radial 2-D
    filter for layers that are not critically sampled. None for one tap.'''
    assert numtaps >= 1
    if numtaps == 1:
        return None
    if not radial:
        f = scipy.signal.firwin(numtaps=numtaps, cutoff=cutoff, width=width, fs=fs)
        return torch.as_tensor(f, dtype=torch.float32)
    x = (np.arange(numtaps) - (numtaps - 1) / 2) / fs
    r = np.hypot(*np.meshgrid(x, x))
    f = scipy.special.j1(2 * cutoff * (np.pi * r)) / (np.pi * r)
    beta = scipy.signal.kaiser_beta(scipy.signal.kaiser_atten(numtaps, width / (fs / 2)))
    w = np.kaiser(numtaps, beta)
    f *= np.outer(w, w)
    f /= np.sum(f)
    return torch.as_tensor(f, dtype=torch.float32)


def get_layer_params(image_size, num_layers, channels, max_channels=512,
                     image_channels=3, margin_size=10, first_cutoff=2,
                     first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3,
                     num_critical=2):
    '''Per-layer channels, sizes, sampling rates, cutoffs and half widths
    (a geometric progression; numpy, used when the layers are built).'''
    last_cutoff = image_size / 2
    last_stopband = last_cutoff * last_stopband_rel
    exponents = np.minimum(np.arange(num_layers + 1) / (num_layers - num_critical), 1)
    cutoffs = first_cutoff * (last_cutoff / first_cutoff) ** exponents
    stopbands = first_stopband * (last_stopband / first_stopband) ** exponents
    sampling_rates = np.exp2(np.ceil(np.log2(np.minimum(stopbands * 2, image_size))))
    half_widths = np.maximum(stopbands, sampling_rates / 2) - cutoffs
    sizes = sampling_rates + margin_size * 2
    sizes[-2:] = image_size
    channels = np.rint(np.minimum((channels / 2) / cutoffs, max_channels))
    channels[-1] = image_channels
    return channels, sizes, sampling_rates, cutoffs, half_widths


class ModulatedConv(nn.Module):
    '''Style-modulated conv, factorized; grows the map by k - 1.
    Weight OIHW.'''

    def __init__(self, in_ch, features, kernel_size=3, demod=True, dtype=torch.float32,
                 generator=None):
        super().__init__()
        k = kernel_size
        self.weight = _normal((features, in_ch, k, k), generator)
        self.scale = 1.0 / np.sqrt(in_ch * k * k)
        self.pad = k - 1
        self.demod = demod
        self.dtype = dtype

    def forward(self, x, s, input_gain=None):
        w = self.weight.float() * self.scale
        x = x * s[:, :, None, None].to(x.dtype)
        if input_gain is not None:
            x = x * input_gain.to(x.dtype)
        y = F.conv2d(x.to(self.dtype), w.to(self.dtype), padding=self.pad)
        if self.demod:
            w2 = (w * w).sum(dim=(2, 3))                             # [out, in]
            d = torch.rsqrt((s.float() ** 2) @ w2.t() + 1e-8)        # [B, out]
            y = y * d[:, :, None, None].to(y.dtype)
        return y


class StyleLayer(nn.Module):
    '''mod-conv -> filtered_lrelu with per-layer designed filters.'''

    def __init__(self, in_channels, style_dim, out_channels, kernel_size, in_size,
                 out_size, in_sampling_rate, out_sampling_rate, in_cutoff, out_cutoff,
                 in_half_width, out_half_width, is_rgb, is_critical_sampled,
                 lrelu_sampling=2, filter_size=6, conv_clamp=256.0, ema_decay=0.999,
                 flrelu_memory='pack', dtype=torch.float32, generator=None):
        super().__init__()
        self.flrelu_memory = flrelu_memory
        self.gain = 1.0 if is_rgb else 2 ** 0.5
        self.negative_slope = 1.0 if is_rgb else 0.2
        self.conv_clamp = conv_clamp
        self.ema_decay = ema_decay
        self.affine = Linear(style_dim, in_channels, bias_init=1.0, generator=generator)

        tmp_srate = max(in_sampling_rate, out_sampling_rate) * (1 if is_rgb else lrelu_sampling)
        self.up_factor = int(np.rint(tmp_srate / in_sampling_rate))
        up_taps = filter_size * self.up_factor if self.up_factor > 1 and not is_rgb else 1
        self.register_buffer('up_filter', design_filter(
            up_taps, in_cutoff, in_half_width * 2, tmp_srate), persistent=False)
        self.down_factor = int(np.rint(tmp_srate / out_sampling_rate))
        down_taps = filter_size * self.down_factor if self.down_factor > 1 and not is_rgb else 1
        self.register_buffer('down_filter', design_filter(
            down_taps, out_cutoff, out_half_width * 2, tmp_srate, not is_critical_sampled),
            persistent=False)

        in_size = np.broadcast_to(np.asarray(in_size), [2])
        out_size = np.broadcast_to(np.asarray(out_size), [2])
        pad_total = (out_size - 1) * self.down_factor + 1
        pad_total = pad_total - (in_size + kernel_size - 1) * self.up_factor
        pad_total = pad_total + up_taps + down_taps - 2
        pad_lo = (pad_total + self.up_factor) // 2
        pad_hi = pad_total - pad_lo
        self.padding = [int(pad_lo[0]), int(pad_hi[0]), int(pad_lo[1]), int(pad_hi[1])]

        self.conv = ModulatedConv(in_channels, out_channels, kernel_size, demod=not is_rgb,
                                  dtype=dtype, generator=generator)
        self.bias = nn.Parameter(torch.zeros(out_channels))
        self.register_buffer('magnitude_ema', torch.ones(()))

    def forward(self, x, w, train: bool = False):
        if train:
            stats = x.detach().float().square().mean()
            self.magnitude_ema.copy_(stats * (1 - self.ema_decay)
                                     + self.magnitude_ema * self.ema_decay)
        input_gain = torch.rsqrt(self.magnitude_ema)
        s = self.affine(w)
        x = self.conv(x, s, input_gain)
        return filtered_lrelu(x, self.up_filter, self.down_filter, self.bias.to(x.dtype),
                              self.up_factor, self.down_factor, self.padding, self.gain,
                              self.negative_slope, self.conv_clamp, memory=self.flrelu_memory)


class SynthesisInput(nn.Module):
    '''Fourier-feature input, rotated and translated per sample from w.'''

    def __init__(self, style_dim, channels, size, sampling_rate, bandwidth,
                 dtype=torch.float32, generator=None):
        super().__init__()
        self.size = int(size)
        self.sampling_rate = float(sampling_rate)
        self.bandwidth = float(bandwidth)
        self.dtype = dtype
        f = torch.randn((channels, 2), generator=generator)
        radii = f.square().sum(dim=1, keepdim=True).sqrt()
        f = f / (radii * torch.exp(radii ** 2) ** 0.25)
        self.register_buffer('freqs', f * self.bandwidth)
        self.register_buffer('phases', torch.rand((channels,), generator=generator) - 0.5)
        self.weight = _normal((channels, channels), generator)
        self.affine = Linear(style_dim, 4, weight_init_zero=True,
                             bias_init=np.asarray([1, 0, 0, 0], np.float32))

    def forward(self, w):
        B = w.shape[0]
        dev = w.device
        t = self.affine(w).float()
        t = t / t[:, :2].norm(dim=1, keepdim=True)
        m_r = torch.eye(3, device=dev).repeat(B, 1, 1)
        m_r[:, 0, 0], m_r[:, 0, 1] = t[:, 0], -t[:, 1]
        m_r[:, 1, 0], m_r[:, 1, 1] = t[:, 1], t[:, 0]
        m_t = torch.eye(3, device=dev).repeat(B, 1, 1)
        m_t[:, 0, 2], m_t[:, 1, 2] = -t[:, 2], -t[:, 3]
        transforms = m_r @ m_t                                       # [B, 3, 3]

        freqs = self.freqs[None]                                     # [1, C, 2]
        phases = self.phases[None] + torch.einsum(
            'bcf,bfk->bck', freqs.expand(B, -1, -1), transforms[:, :2, 2:])[..., 0]
        freqs = torch.einsum('bcf,bfk->bck', freqs.expand(B, -1, -1), transforms[:, :2, :2])
        amp = torch.clamp(1 - (freqs.norm(dim=2) - self.bandwidth)
                          / (self.sampling_rate / 2 - self.bandwidth), 0, 1)

        span = 0.5 * self.size / self.sampling_rate
        coords = ((2 * torch.arange(self.size, device=dev) + 1) / self.size - 1) * span
        gy, gx = torch.meshgrid(coords, coords, indexing='ij')
        grid = torch.stack([gx, gy], dim=-1)                         # [H, W, 2]
        x = torch.einsum('hwf,bcf->bchw', grid, freqs) + phases[:, :, None, None]
        x = torch.sin(x * (np.pi * 2)) * amp[:, :, None, None]
        proj = (self.weight / np.sqrt(self.weight.shape[0])).to(self.dtype)
        return F.conv2d(x.to(self.dtype), proj[:, :, None, None])


class Mapping(nn.Module):
    '''Pixel norm, dense + lrelu layers, and the w_avg EMA / truncation.'''

    def __init__(self, latent_dim, style_dim, num_layers=2, pixel_norm=True,
                 ema_decay=0.998, generator=None):
        super().__init__()
        self.pixel_norm = pixel_norm
        self.ema_decay = ema_decay
        self.layers = nn.ModuleList(
            Linear(latent_dim if i == 0 else style_dim, style_dim, True, 'lrelu',
                   generator=generator)
            for i in range(num_layers))
        self.register_buffer('w_avg', torch.zeros(style_dim))

    def forward(self, z, truncation_psi: float = 1.0, train: bool = False):
        x = z.float()
        if self.pixel_norm:
            x = x / (torch.sqrt((x * x).mean(dim=1, keepdim=True)) + 1e-8)
        for layer in self.layers:
            x = layer(x)
        if train:
            self.w_avg.copy_(x.detach().mean(dim=0) * (1 - self.ema_decay)
                             + self.w_avg * self.ema_decay)
        if truncation_psi != 1:
            x = self.w_avg[None] + (x - self.w_avg[None]) * truncation_psi
        return x


class Synthesis(nn.Module):
    '''The alias-free synthesis stack: input, num_layers + 1 style layers.'''

    def __init__(self, image_size, num_layers=14, channels=32, max_channels=512,
                 style_dim=512, image_channels=3, output_scale=0.25, margin_size=10,
                 first_cutoff=2, first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3,
                 kernel_size=3, flrelu_memory='pack', dtype=torch.float32, generator=None):
        super().__init__()
        self.num_layers = num_layers
        self.output_scale = output_scale
        log_resl_diff = int(math.log2(512) - math.log2(image_size))
        chan_base = int(2 ** (15 - log_resl_diff) * (channels / 64))
        chans, sizes, srates, cutoffs, half_widths = get_layer_params(
            image_size, num_layers, chan_base, max_channels, image_channels, margin_size,
            first_cutoff, first_stopband, last_stopband_rel, num_critical=2)
        self.input = SynthesisInput(style_dim, int(chans[0]), int(sizes[0]),
                                    float(srates[0]), float(cutoffs[0]), dtype=dtype,
                                    generator=generator)
        layers = []
        for i in range(num_layers + 1):
            prev = max(i - 1, 0)
            is_rgb = i == num_layers
            layers.append(StyleLayer(
                int(chans[prev]), style_dim, int(chans[i]), 1 if is_rgb else kernel_size,
                int(sizes[prev]), int(sizes[i]), float(srates[prev]), float(srates[i]),
                float(cutoffs[prev]), float(cutoffs[i]), float(half_widths[prev]),
                float(half_widths[i]), is_rgb, i >= num_layers - 2,
                flrelu_memory=flrelu_memory, dtype=dtype, generator=generator))
        self.net = nn.ModuleList(layers)

    @property
    def num_ws(self):
        return self.num_layers + 2

    def forward(self, w, train: bool = False):
        ws = [w] * self.num_ws if w.ndim == 2 else list(w.unbind(dim=1))
        x = self.input(ws[0])
        for layer, wi in zip(self.net, ws[1:]):
            x = layer(x, wi, train=train)
        return x.float() * self.output_scale


class Generator(nn.Module):
    '''Mapping + alias-free synthesis. forward(z, truncation_psi, train).'''

    def __init__(self, image_size=256, latent_dim=512, num_layers=14, map_num_layers=2,
                 channels=32, max_channels=512, style_dim=512, pixel_norm=True,
                 image_channels=3, output_scale=0.25, margin_size=10, first_cutoff=2,
                 first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, kernel_size=3,
                 flrelu_memory='pack', dtype=torch.float32, generator=None):
        super().__init__()
        self.latent_dim = latent_dim
        self.map = Mapping(latent_dim, style_dim, map_num_layers, pixel_norm,
                           generator=generator)
        self.synthesis = Synthesis(
            image_size, num_layers, channels, max_channels, style_dim, image_channels,
            output_scale, margin_size, first_cutoff, first_stopband, last_stopband_rel,
            kernel_size, flrelu_memory, dtype=dtype, generator=generator)

    def moment_buffers(self):
        '''The buffers a forward with `train=True` updates (the JAX
        'moments' that change): each layer's magnitude_ema and w_avg.'''
        return [self.map.w_avg] + [layer.magnitude_ema for layer in self.synthesis.net]

    def forward(self, z, truncation_psi: float = 1.0, train: bool = False):
        return self.synthesis(self.map(z, truncation_psi, train=train), train=train)


# ---------------- discriminator ----------------

def binomial_filter(filter_size: int):
    def c(n, k):
        if k <= 0 or n <= k:
            return 1
        return c(n - 1, k - 1) + c(n - 1, k)
    return [c(filter_size - 1, j) for j in range(filter_size)]


class ConvAct(nn.Module):
    '''Conv with equalized learning rate, an optional binomial-filtered
    down-sampling and bias_act; weight OIHW.'''

    def __init__(self, in_ch, features, kernel_size=3, use_bias=True, down=1,
                 filter_size=4, act_name='linear', gain=1.0, act_gain=None,
                 dtype=torch.float32, generator=None):
        super().__init__()
        k = kernel_size
        self.weight = _normal((features, in_ch, k, k), generator)
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        self.scale = gain / np.sqrt(in_ch * k * k)
        self.down = down
        self.pad = k // 2
        self.act_name = act_name
        self.act_gain = act_gain
        self.dtype = dtype
        f = None
        if down > 1:
            fil = np.asarray(binomial_filter(filter_size), np.float64)
            kern = np.outer(fil, fil)
            f = torch.as_tensor(kern / kern.sum(), dtype=torch.float32)
        self.register_buffer('filter', f, persistent=False)

    def forward(self, x):
        y = conv2d_resample(x.to(self.dtype), (self.weight * self.scale).to(self.dtype),
                            self.filter, down=self.down, padding=self.pad)
        b = None if self.bias is None else self.bias.to(y.dtype)
        return bias_act(y, b, act=self.act_name, gain=self.act_gain)


class ResBlock(nn.Module):
    '''conv -> down-conv, skip 1x1 down-conv; both branches scaled 1/sqrt(2).'''

    def __init__(self, in_ch, features, filter_size=4, act_name='lrelu', gain=1.0,
                 dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        self.conv1 = ConvAct(in_ch, features, 3, True, 1, filter_size, act_name, gain, **kw)
        self.conv2 = ConvAct(features, features, 3, True, 2, filter_size, act_name, gain,
                             0.5 ** 0.5, **kw)
        self.skip = ConvAct(in_ch, features, 1, False, 2, filter_size, 'linear', gain,
                            0.5 ** 0.5, **kw)

    def forward(self, x):
        return self.conv2(self.conv1(x)) + self.skip(x)


class MinibatchStdDev(nn.Module):
    '''Stddev over groups of samples, appended as `num_channels` channels.
    Group m holds samples {m, m + N/G, ...} (reshape(G, N/G, ...)); the
    whole batch is one group when it does not divide by the group size.'''

    def __init__(self, group_size=4, num_channels=1):
        super().__init__()
        self.group_size = group_size
        self.num_channels = num_channels

    def forward(self, x):
        N, C, H, W = x.shape
        G = self.group_size if N % self.group_size == 0 else N
        Fc = self.num_channels
        y = x.float().reshape(G, N // G, Fc, C // Fc, H, W)
        y = y - y.mean(dim=0, keepdim=True)
        y = torch.sqrt((y * y).mean(dim=0) + 1e-8)                  # [N/G, F, C/F, H, W]
        y = y.mean(dim=(2, 3, 4)).repeat(G, 1)                       # [N, F]
        y = y[:, :, None, None].expand(N, Fc, H, W).to(x.dtype)
        return torch.cat([x, y], dim=1)


class Discriminator(nn.Module):
    '''Binomial-filtered residual D. Its last feature map is flattened in
    the JAX package's (H, W, C) order, so converted weights carry over.'''

    def __init__(self, image_size=256, in_channels=3, channels=64, max_channels=512,
                 mbsd_group_size=4, mbsd_channels=1, bottom=4, filter_size=4,
                 act_name='lrelu', gain=1.0, dtype=torch.float32, generator=None):
        super().__init__()
        kw = dict(dtype=dtype, generator=generator)
        num_downs = int(math.log2(image_size) - math.log2(bottom))
        c = channels
        self.from_rgb = ConvAct(in_channels, c, 1, True, 1, None, act_name, gain, **kw)
        blocks, ich, och = [], c, c
        for _ in range(num_downs):
            c *= 2
            och = min(max_channels, c)
            blocks.append(ResBlock(ich, och, filter_size, act_name, gain, **kw))
            ich = och
        self.blocks = nn.ModuleList(blocks)
        self.mbsd = MinibatchStdDev(mbsd_group_size, mbsd_channels)
        self.conv = ConvAct(och + mbsd_channels, och, 3, True, 1, None, act_name, gain, **kw)
        self.fc = Linear(och * bottom * bottom, och, True, act_name, gain, generator=generator)
        self.out = Linear(och, 1, True, 'linear', gain, generator=generator)
        self.dtype = dtype

    def forward(self, x):
        x = self.from_rgb(x.to(self.dtype))
        for block in self.blocks:
            x = block(x)
        x = self.conv(self.mbsd(x))
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return self.out(self.fc(x)).float()
