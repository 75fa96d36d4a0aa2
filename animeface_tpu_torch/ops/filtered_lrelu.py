'''filtered_lrelu — bias, up-FIR, gain * leaky ReLU, clamp, down-FIR (NCHW).

Counterpart of `animeface_tpu/ops/filtered_lrelu.py`, the StyleGAN3
per-layer op:

    bias_act(b) -> upfirdn2d(fu, up, gain=up**2)
    -> bias_act(lrelu, alpha=slope, gain, clamp) -> upfirdn2d(fd, down)

Three memory modes, one function:
  * 'store': the composition above under autograd, which keeps the
    up-sampled intermediate for the backward;
  * 'pack': an autograd Function whose only residual is a 2-bit gate code
    per up-sampled element (positive / leaky / clamped), four codes to a
    byte; the backward applies the exact adjoints of the two FIR stages
    (upfirdn2d with up and down swapped, the filter flipped and the padding
    transposed) around the code's slope. That is the JAX package's
    `memory='pack'` and the reference CUDA kernel's sign tensor. (The JAX
    package's layout knobs, ANIMEFACE_PACK_LAYOUT/_PACK_VEC, worked around
    the TPU compiler and have no counterpart.)
  * 'remat': 'store' under `torch.utils.checkpoint`, so the backward
    recomputes the intermediate from the input.

The ops registry (`ops/registry.py`) applies to 'store' only, as in the
JAX package: with impl 'cuda', a call in the kernel's scope (up = down = 2,
1-D filters, non-negative padding, C % 128 == 0, out_h == H and
out_h % 8 == 0) runs the hand-written fused kernel
(`ops/cuda_kernels.py:filtered_lrelu`, forward only), the counterpart of
`filtered_lrelu_pallas`. 'pack' and 'remat' ignore `impl`; StyleGAN3 runs
'pack', so no StyleGAN3 layer reaches the kernel (none is in its scope
either: the conv grows each map by 2).
'''

from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from animeface_tpu_torch.ops import cuda_kernels
from animeface_tpu_torch.ops.bias_act import bias_act
from animeface_tpu_torch.ops.registry import resolve_impl
from animeface_tpu_torch.ops.upfirdn2d import upfirdn2d, _parse_padding, _get_filter_size

_ONES = torch.ones((1,), dtype=torch.float32)


def _upfirdn2d_adjoint(dy, f, in_hw, up, down, padding, gain):
    '''The transpose of `upfirdn2d(x, f, up, down, padding, gain=gain)` for
    x of spatial size `in_hw`, applied to dy.'''
    fw, fh = _get_filter_size(f)
    px0, px1, py0, py1 = padding
    ih, iw = in_hw
    oh, ow = dy.shape[2:]
    p = [fw - px0 - 1, iw * up - ow * down + px0 - up + 1,
         fh - py0 - 1, ih * up - oh * down + py0 - up + 1]
    return upfirdn2d(dy, f, up=down, down=up, padding=p, flip_filter=True, gain=gain)


def pack_codes(codes):
    '''uint8 codes in {0, 1, 2}, any shape -> four per byte, flattened.'''
    flat = codes.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % 4)).reshape(-1, 4)
    return flat[:, 0] | (flat[:, 1] << 2) | (flat[:, 2] << 4) | (flat[:, 3] << 6)


def unpack_codes(packed, shape):
    '''Inverse of `pack_codes` for the original `shape`.'''
    q = torch.stack([(packed >> s) & 3 for s in (0, 2, 4, 6)], dim=1).reshape(-1)
    return q[:int(np.prod(shape))].reshape(shape)


class _PackedFilteredLRelu(torch.autograd.Function):
    '''filtered_lrelu with the 2-bit gate code as its only residual.'''

    @staticmethod
    def forward(ctx, x, b, fu, fd, up, down, padding, gain, slope, clamp):
        z = upfirdn2d(x + b.reshape(1, -1, 1, 1).to(x.dtype), fu, up=up, padding=padding,
                      gain=up ** 2)
        pos = z >= 0
        e = torch.where(pos, z, z * slope) * gain
        codes = pos.to(torch.uint8) + 1                  # 2 positive, 1 leaky
        if clamp is not None:
            live = e.abs() <= clamp
            e = e.clamp(-clamp, clamp)
            codes = codes * live                             # 0 clamped
        ctx.save_for_backward(pack_codes(codes), fu, fd)
        ctx.cfg = (x.shape[2:], z.shape, up, down, padding, gain, slope, b.dtype)
        return upfirdn2d(e, fd, down=down)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        packed, fu, fd = ctx.saved_tensors
        in_hw, z_shape, up, down, padding, gain, slope, b_dtype = ctx.cfg
        dz = _upfirdn2d_adjoint(dy, fd, z_shape[2:], 1, down, (0, 0, 0, 0), 1)
        codes = unpack_codes(packed, z_shape)
        mult = torch.tensor([0.0, gain * slope, gain], dtype=dz.dtype, device=dz.device)
        dz = dz * mult[codes.long()]
        dx = _upfirdn2d_adjoint(dz, fu, in_hw, up, 1, padding, up ** 2)
        db = dx.float().sum(dim=(0, 2, 3)).to(b_dtype) if ctx.needs_input_grad[1] else None
        return (dx, db) + (None,) * 8


def filtered_lrelu(x, fu=None, fd=None, b=None, up: int = 1, down: int = 1, padding=0,
                   gain: float = float(np.sqrt(2)), slope: float = 0.2, clamp=None,
                   memory: str = 'store', impl: str | None = None):
    '''See the module docstring; x is NCHW, b has one entry per channel.'''
    assert x.ndim == 4, 'expected NCHW'
    fu_w, fu_h = _get_filter_size(fu)
    fd_w, fd_h = _get_filter_size(fd)
    if b is not None:
        assert b.shape[0] == x.shape[1]
    assert isinstance(up, int) and up >= 1
    assert isinstance(down, int) and down >= 1
    padding = _parse_padding(padding)
    assert gain > 0 and slope >= 0
    assert clamp is None or clamp >= 0
    assert memory in ('store', 'pack', 'remat'), memory

    N, C, H, W = x.shape
    px0, px1, py0, py1 = padding
    out_w = (W * up + (px0 + px1) - (fu_w - 1) - (fd_w - 1) + (down - 1)) // down
    out_h = (H * up + (py0 + py1) - (fu_h - 1) - (fd_h - 1) + (down - 1)) // down

    if memory == 'pack':
        if b is None:
            b = torch.zeros((C,), dtype=x.dtype, device=x.device)
        ones = _ONES.to(x.device)
        out = _PackedFilteredLRelu.apply(
            x, b, ones if fu is None else fu.float(), ones if fd is None else fd.float(),
            up, down, padding, float(gain), float(slope),
            None if clamp is None else float(clamp))
    elif memory == 'remat':
        out = checkpoint(
            lambda x_, b_: filtered_lrelu(x_, fu, fd, b_, up, down, padding, gain, slope,
                                          clamp, memory='store', impl='torch'),
            x, b, use_reentrant=False)
    elif resolve_impl(impl) == 'cuda' and cuda_kernels.filtered_lrelu_in_scope(
            x.shape, fu, fd, up, down, padding):
        out = cuda_kernels.filtered_lrelu(x, fu, fd, b, padding, float(gain), float(slope),
                                          None if clamp is None else float(clamp))
    else:
        out = bias_act(x, b)
        out = upfirdn2d(out, fu, up=up, padding=padding, gain=up ** 2)
        out = bias_act(out, act='lrelu', alpha=slope, gain=gain, clamp=clamp)
        out = upfirdn2d(out, fd, down=down)
    assert out.shape == (N, C, out_h, out_w), (out.shape, (N, C, out_h, out_w))
    assert out.dtype == x.dtype
    return out
