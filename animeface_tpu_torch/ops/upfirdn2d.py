'''upfirdn2d — pad, zero-insert upsample, FIR filter, downsample (NCHW).

Counterpart of `animeface_tpu/ops/upfirdn2d.py`. The JAX package ran this
as one XLA convolution, with no Pallas kernel (`upfirdn2d_pallas = None`),
so here it is a depthwise `conv2d` on cuDNN:
  * the upsample inserts `up-1` zeros AFTER each sample (size H*up), the
    reference convention; JAX got the same by folding those trailing zeros
    into the high-side padding;
  * negative padding crops;
  * a 1-D filter runs as two separable passes, each scaled by gain**0.5.

Filters are float32 `[fh, fw]` or `[taps]`. `flip_filter=False` means
convolution (the filter is flipped), True means correlation.
'''

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def _parse_scaling(scaling):
    if isinstance(scaling, int):
        scaling = [scaling, scaling]
    sx, sy = scaling
    assert sx >= 1 and sy >= 1
    return int(sx), int(sy)


def _parse_padding(padding):
    if isinstance(padding, int):
        padding = [padding, padding]
    padding = [int(p) for p in padding]
    if len(padding) == 2:
        padx, pady = padding
        padding = [padx, padx, pady, pady]
    padx0, padx1, pady0, pady1 = padding
    return padx0, padx1, pady0, pady1


def _get_filter_size(f):
    if f is None:
        return 1, 1
    assert f.ndim in (1, 2)
    return int(f.shape[-1]), int(f.shape[0])  # width, height


def setup_filter(f, normalize: bool = True, flip_filter: bool = False,
                 gain: float = 1, separable=None, device=None):
    '''Prepare a FIR filter for `upfirdn2d`: float32, unit DC gain, optionally
    flipped, scaled by gain**(ndim/2). 1-D filters with >= 8 taps stay
    separable by default.'''
    if f is None:
        f = 1
    f = torch.as_tensor(np.asarray(f, np.float32) if not torch.is_tensor(f) else f,
                        dtype=torch.float32, device=device)
    assert f.ndim in (0, 1, 2)
    assert f.numel() > 0
    if f.ndim == 0:
        f = f[None]
    if separable is None:
        separable = (f.ndim == 1 and f.numel() >= 8)
    if f.ndim == 1 and not separable:
        f = torch.outer(f, f)
    assert f.ndim == (1 if separable else 2)
    if normalize:
        f = f / f.sum()
    if flip_filter:
        f = f.flip(list(range(f.ndim)))
    return f * (gain ** (f.ndim / 2))


def _depthwise_fir(x, f2d, up, down, padding, gain):
    '''One depthwise FIR pass on NCHW x; f2d [fh, fw] in correlation
    orientation.'''
    N, C, H, W = x.shape
    upx, upy = up
    downx, downy = down
    padx0, padx1, pady0, pady1 = padding
    fh, fw = f2d.shape
    assert W * upx + padx0 + padx1 >= fw and H * upy + pady0 + pady1 >= fh, \
        'upsampled buffer smaller than the filter'
    if upx > 1 or upy > 1:
        z = x.new_zeros((N, C, H * upy, W * upx))
        z[:, :, ::upy, ::upx] = x
        x = z
    x = F.pad(x, [padx0, padx1, pady0, pady1])
    weight = (f2d * gain).to(device=x.device, dtype=x.dtype)
    weight = weight[None, None].expand(C, 1, fh, fw)
    return F.conv2d(x, weight, stride=(downy, downx), groups=C)


def upfirdn2d(x, f, up=1, down=1, padding=0, flip_filter: bool = False,
              gain: float = 1):
    '''Pad, upsample, filter and downsample a batch of NCHW images.'''
    upx, upy = _parse_scaling(up)
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    if f is None:
        f = torch.ones((1, 1), dtype=torch.float32)
    f = torch.as_tensor(f, dtype=torch.float32)
    if not flip_filter:
        f = f.flip(list(range(f.ndim)))
    if f.ndim == 2:
        return _depthwise_fir(x, f, (upx, upy), (downx, downy),
                              (padx0, padx1, pady0, pady1), gain)
    g = gain ** 0.5
    x = _depthwise_fir(x, f[None, :], (upx, 1), (downx, 1),
                       (padx0, padx1, 0, 0), g)
    return _depthwise_fir(x, f[:, None], (1, upy), (1, downy),
                          (0, 0, pady0, pady1), g)


def filter2d(x, f, padding=0, flip_filter=False, gain=1):
    '''Same-size FIR filtering.'''
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + fw // 2, padx1 + (fw - 1) // 2,
         pady0 + fh // 2, pady1 + (fh - 1) // 2]
    return upfirdn2d(x, f, padding=p, flip_filter=flip_filter, gain=gain)


def upsample2d(x, f, up=2, padding=0, flip_filter=False, gain=1):
    '''FIR-interpolated upsampling.'''
    upx, upy = _parse_scaling(up)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw + upx - 1) // 2, padx1 + (fw - upx) // 2,
         pady0 + (fh + upy - 1) // 2, pady1 + (fh - upy) // 2]
    return upfirdn2d(x, f, up=up, padding=p, flip_filter=flip_filter,
                     gain=gain * upx * upy)


def downsample2d(x, f, down=2, padding=0, flip_filter=False, gain=1):
    '''FIR-antialiased downsampling.'''
    downx, downy = _parse_scaling(down)
    padx0, padx1, pady0, pady1 = _parse_padding(padding)
    fw, fh = _get_filter_size(f)
    p = [padx0 + (fw - downx + 1) // 2, padx1 + (fw - downx) // 2,
         pady0 + (fh - downy + 1) // 2, pady1 + (fh - downy) // 2]
    return upfirdn2d(x, f, down=down, padding=p, flip_filter=flip_filter,
                     gain=gain)
