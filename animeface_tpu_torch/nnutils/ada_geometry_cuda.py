'''Hand-written CUDA kernels for the ADA two-pass warp (`csrc/ada_twopass.cu`).

Replaces the Pallas TPU kernel pair `twopass_fused` of
`animeface_tpu/nnutils/ada_geometry_tpu.py` (`_fwd2_kernel` forward,
`_bwd2_kernel` backward). `twopass_fused` keeps the TPU kernel's argument
layout, so the parameters that `_pass_params` builds feed either side:

    x:     [B, C, N, Wep]   extended canvas (live columns < We)
    t1/f1: [B, Wep]         pass-1 per-column shift (mod P1) / blend
    M1:    [B, N, P1p]      pass-1 kernel matrix (columns >= P1 ignored)
    t2/f2: [B, N]           pass-2 per-row shift (mod P2) / blend
    M2:    [B, out, P2p]    pass-2 kernel matrix (columns >= P2 ignored)
    returns [B, C, out, N]  (transposed: x-axis first)

Gradients flow to `x` only: t, f and M are augmentation draws. A CPU tensor
takes `twopass_fused_plain`, the same function in index gathers and
einsums; a CUDA tensor launches the kernels and raises if it cannot.

Bound at the main-path shapes (B=32, 256px: N=256, We=Wep=384, f32): the
call reads x, M1 and M2 and writes the output, 3.28 MB per image, 105 MB in
all: 31 us at 3.35 TB/s. M is banded (13 taps a row), so the work is bound
by bytes; the kernels skip the zeros of M (see the source's header) and
the next step is to read only M's band.
'''

from __future__ import annotations

import ctypes

import torch

#: launches of the forward kernel / of the backward kernel chain, counted by
#: the wrappers below (a run can show that it went through the kernels)
fwd_launches = 0
bwd_launches = 0

_SOURCE = 'ada_twopass'
_lib = None


def _library():
    global _lib
    if _lib is None:
        from animeface_tpu_torch._build import library
        lib = library(_SOURCE)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.ada_twopass_fwd.argtypes = [p] * 8 + [i] * 10 + [p]
        lib.ada_twopass_fwd.restype = ctypes.c_int
        lib.ada_twopass_bwd.argtypes = [p] * 11 + [i] * 10 + [p]
        lib.ada_twopass_bwd.restype = ctypes.c_int
        lib.ada_twopass_smem_bytes.argtypes = [i] * 10
        lib.ada_twopass_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _mirror(j, n):
    return torch.where(j < n, j, 2 * n - 2 - j)


def _shift_blend(z, t, f, P, n):
    '''v[l] = (1-f) z[mir((l+t) mod P)] + f z[mir((l+1+t) mod P)] along
    axis 2 of z [B, C, n, L], with per-lane t/f [B, L].'''
    B, C, _, L = z.shape
    lines = torch.arange(P, device=z.device)
    j0 = torch.remainder(lines[None, :, None] + t[:, None, :].long(), P)
    j1 = torch.remainder(j0 + 1, P)
    g0 = z.gather(2, _mirror(j0, n)[:, None].expand(B, C, P, L))
    g1 = z.gather(2, _mirror(j1, n)[:, None].expand(B, C, P, L))
    f = f[:, None, None, :]
    return (1 - f) * g0 + f * g1


def twopass_fused_plain(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
    '''The kernels' function in plain PyTorch (differentiable by autograd).'''
    N = x.shape[2]
    v1 = _shift_blend(x, t1, f1, P1, N)                          # [B,C,P1,Wep]
    y1 = torch.einsum('brl,bclw->bcrw', M1[:, :, :P1], v1)[..., :We]
    v2 = _shift_blend(y1.transpose(2, 3), t2, f2, P2, We)        # [B,C,P2,N]
    return torch.einsum('bol,bcln->bcon', M2[:, :, :P2], v2)[:, :, :out_len]


def _check(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
    B, C, N, Wep = x.shape
    for name, tensor, dtype, shape in (
            ('x', x, torch.float32, None), ('t1', t1, torch.int32, (B, Wep)),
            ('f1', f1, torch.float32, (B, Wep)),
            ('M1', M1, torch.float32, (B, N, M1.shape[2])),
            ('t2', t2, torch.int32, (B, N)), ('f2', f2, torch.float32, (B, N)),
            ('M2', M2, torch.float32, (B, out_len, M2.shape[2]))):
        if tensor.device != x.device:
            raise ValueError(f'{name} is on {tensor.device}, x on {x.device}')
        if tensor.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {tensor.dtype}')
        if shape is not None and tuple(tensor.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(tensor.shape)}, '
                             f'expected {shape}')
        if not tensor.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if P1 != 2 * N - 2 or P2 != 2 * We - 2 or not 2 <= We <= Wep:
        raise ValueError(f'inconsistent periods P1={P1} P2={P2} for '
                         f'N={N} We={We} Wep={Wep}')
    if M1.shape[2] < P1 or M2.shape[2] < P2:
        raise ValueError('M1/M2 must hold at least P1/P2 columns')


def _dims(x, M1, M2, P1, P2, We, out_len):
    B, C, N, Wep = x.shape
    return [B, C, N, Wep, We, P1, M1.shape[2], P2, M2.shape[2], out_len]


def _launch_fwd(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
    global fwd_launches
    lib = _library()
    dims = _dims(x, M1, M2, P1, P2, We, out_len)
    out = torch.empty((x.shape[0], x.shape[1], out_len, x.shape[2]),
                      dtype=torch.float32, device=x.device)
    err = lib.ada_twopass_fwd(
        x.data_ptr(), t1.data_ptr(), f1.data_ptr(), M1.data_ptr(),
        t2.data_ptr(), f2.data_ptr(), M2.data_ptr(), out.data_ptr(), *dims,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f'ada_twopass_fwd failed: CUDA error {err} '
                           f'(shared memory {lib.ada_twopass_smem_bytes(*dims)} B)')
    fwd_launches += 1
    return out


def _launch_bwd(g, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
    global bwd_launches
    lib = _library()
    B, C, _, N = g.shape
    Wep = t1.shape[1]
    dims = [B, C, N, Wep, We, P1, M1.shape[2], P2, M2.shape[2], out_len]
    opts = dict(dtype=torch.float32, device=g.device)
    dx = torch.empty((B, C, N, Wep), **opts)
    dy1 = torch.empty((B, C, N, We), **opts)
    M1T = torch.empty((B, P1, N), **opts)
    M2T = torch.empty((B, P2, out_len), **opts)
    err = lib.ada_twopass_bwd(
        g.data_ptr(), t1.data_ptr(), f1.data_ptr(), M1.data_ptr(),
        t2.data_ptr(), f2.data_ptr(), M2.data_ptr(), dx.data_ptr(),
        dy1.data_ptr(), M1T.data_ptr(), M2T.data_ptr(), *dims,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f'ada_twopass_bwd failed: CUDA error {err} '
                           f'(shared memory {lib.ada_twopass_smem_bytes(*dims)} B)')
    bwd_launches += 1
    return dx


class _TwoPassFused(torch.autograd.Function):
    '''Forward kernel; backward kernel chain (first order only: R1 skips
    augmentation and the path-length penalty never reaches D).'''

    @staticmethod
    def forward(ctx, x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
        ctx.save_for_backward(t1, f1, M1, t2, f2, M2)
        ctx.dims = (P1, P2, We, out_len)
        return _launch_fwd(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        t1, f1, M1, t2, f2, M2 = ctx.saved_tensors
        dx = _launch_bwd(g.contiguous(), t1, f1, M1, t2, f2, M2, *ctx.dims)
        return (dx,) + (None,) * 10


def twopass_fused(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
    '''Both warp passes; the CUDA kernels for a CUDA tensor, the plain
    version for a CPU tensor.'''
    if x.device.type == 'cpu':
        return twopass_fused_plain(x, t1, f1, M1, t2, f2, M2, P1, P2, We,
                                   out_len)
    if x.device.type != 'cuda':
        raise ValueError(f'twopass_fused runs on cuda or cpu, not {x.device}')
    _check(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)
    return _TwoPassFused.apply(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)

