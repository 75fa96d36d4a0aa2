'''conv2d_resample — 2-D convolution with FIR-filtered downsampling (NCHW).

Counterpart of `animeface_tpu/ops/conv2d_resample.py`, cut to what the
StyleGAN3 discriminator's `ConvAct` uses: a same-size conv, or a conv
followed by a FIR downsample. Padding is taken once, up front, adjusted for
the filter; a 1x1 kernel commutes with the downsampling, so it runs on the
downsampled map. The JAX package left this to XLA; here the convolutions
run on cuDNN.

Weights are OIHW `[out, in, kh, kw]`, applied as a correlation.
'''

from __future__ import annotations

import torch.nn.functional as F

from animeface_tpu_torch.ops.upfirdn2d import upfirdn2d, _get_filter_size


def conv2d_resample(x, w, f=None, down: int = 1, padding: int = 0):
    '''x: [N, C, H, W]; w: [out, C, kh, kw]; f: the downsampling filter
    (`[fh, fw]` or `[taps]`), used when down > 1; `padding` on each side.'''
    assert x.ndim == 4 and w.ndim == 4
    assert isinstance(down, int) and down >= 1
    w = w.to(x.dtype)
    if down == 1:
        return F.conv2d(x, w, padding=padding)
    fw, fh = _get_filter_size(f)
    p = [padding + (fw - down + 1) // 2, padding + (fw - down) // 2,
         padding + (fh - down + 1) // 2, padding + (fh - down) // 2]
    if w.shape[2] == 1 and w.shape[3] == 1:
        return F.conv2d(upfirdn2d(x, f, down=down, padding=p), w)
    return upfirdn2d(F.conv2d(F.pad(x, p), w), f, down=down)
