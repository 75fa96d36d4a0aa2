'''Hand-written CUDA kernels for the ADA two-pass warp.

Two kernel pairs, each replacing a Pallas TPU pair of
`animeface_tpu/nnutils/ada_geometry_tpu.py`:

* `twopass_fused` (`csrc/ada_twopass.cu`) replaces `twopass_fused`
  (`_fwd2_kernel` forward, `_bwd2_kernel` backward): both passes in one
  call, for shapes that pass the gate N % 8 == 0 and We % 128 == 0 (256px);
* `linepass_fused` (`csrc/ada_linepass.cu`) replaces `linepass_fused`
  (`_fwd_kernel` forward, `_bwd_kernel` backward): one line pass, called
  once per pass for every other shape (128px: We = 192).

`twopass_fused` keeps the TPU kernel's argument layout, so the parameters
that `_pass_params` builds feed either side:

    x:     [B, C, N, Wep]   extended canvas (live columns < We)
    t1/f1: [B, Wep]         pass-1 per-column shift (mod P1) / blend
    M1:    [B, N, P1p]      pass-1 kernel matrix (columns >= P1 ignored)
    t2/f2: [B, N]           pass-2 per-row shift (mod P2) / blend
    M2:    [B, out, P2p]    pass-2 kernel matrix (columns >= P2 ignored)
    returns [B, C, out, N]  (transposed: x-axis first)

`linepass_fused` reads the undoubled map through the mirror index (the TPU
kernel took the materialised double canvas z2):

    z:     [B, C, N, W]     lines along axis 2 (period P = 2N - 2)
    t/f:   [B, W]           per-column shift (mod P) / blend
    M:     [B, out, Pp]     kernel matrix (columns >= P ignored)
    returns [B, C, out, W]

Gradients flow to `x`/`z` only: t, f and M are augmentation draws. A CPU
tensor takes the plain version (`twopass_fused_plain`,
`linepass_fused_plain`), the same function in index gathers and einsums; a
CUDA tensor launches the kernels and raises if it cannot.

Bound at the main-path shapes (B=32, 256px: N=256, We=Wep=384, f32): the
call reads x, M1 and M2 and writes the output, 3.28 MB per image, 105 MB in
all: 31 us at 3.35 TB/s. At the 128px shapes one line pass reads z and M
and writes its output, 22-23 MB: about 7 us. M is banded (13 taps a row),
so the work is bound by bytes; the kernels skip the zeros of M (see the
sources' headers) and the next step is to read only M's band.

Both forwards first list the nonzeros of each row of their M
(`twopass_row_lists_plain` is that list format in plain PyTorch) and then
sum over the lists only; `twopass_fwd_lists_plain` and
`linepass_fwd_lists_plain` are the same forwards in plain PyTorch, in the
kernels' order. The backwards do the same with the columns
(`twopass_tap_lists_plain`, `twopass_bwd_lists_plain`,
`linepass_bwd_lists_plain`). These serve the tests and `chip_smoke.py`;
the wrappers never call them.
'''

from __future__ import annotations

import ctypes

import torch

#: launches of each forward kernel / backward kernel chain, counted by the
#: wrappers below (a run can show that it went through the kernels)
fwd_launches = 0
bwd_launches = 0
line_fwd_launches = 0
line_bwd_launches = 0

_p, _i = ctypes.c_void_p, ctypes.c_int
#: C functions of each source: the number of int dims that each of them
#: takes, and its entry points as (name, pointer args); `<source>_smem_bytes`
#: takes the dims alone
_ENTRIES = {
    'ada_twopass': (10, [('ada_twopass_fwd', 14), ('ada_twopass_bwd', 15)]),
    'ada_linepass': (7, [('ada_linepass_fwd', 8), ('ada_linepass_bwd', 8)]),
}
_libs = {}


def _library(source):
    lib = _libs.get(source)
    if lib is None:
        from animeface_tpu_torch._build import library
        lib = library(source)
        n_dims, entries = _ENTRIES[source]
        for name, n_ptr in entries:
            fn = getattr(lib, name)
            fn.argtypes = [_p] * n_ptr + [_i] * n_dims + [_p]    # ..., stream
            fn.restype = ctypes.c_int
        smem = getattr(lib, f'{source}_smem_bytes')
        smem.argtypes = [_i] * n_dims
        smem.restype = ctypes.c_size_t
        _libs[source] = lib
    return lib


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


def twopass_tap_lists_plain(M, P):
    '''The tap lists the backward kernel chain builds from M [B, R, Pp]:
    for each column l < P, count [B, P] nonzeros M[b, r, l], listed as
    idx [B, P, R] (int32, rows ascending) and val [B, P, R]; entries at or
    past the count are 0 here (the kernel leaves them unwritten).'''
    cols = M[:, :, :P].transpose(1, 2)                             # [B, P, R]
    nonzero = cols != 0
    count = nonzero.sum(-1, dtype=torch.int32)
    rows = torch.sort((~nonzero).int(), dim=-1, stable=True).indices
    keep = torch.arange(M.shape[1], device=M.device) < count[..., None]
    return (count, torch.where(keep, rows, 0).int(),
            torch.where(keep, cols.gather(-1, rows), 0.0))


def twopass_row_lists_plain(M, P):
    '''The row lists the forward kernels build from M [B, R, Pp]: for each
    row r, count [B, R] nonzeros M[b, r, l] among the columns l < P, listed
    as idx [B, R, P] (int32, columns ascending) and val [B, R, P]; entries
    at or past the count are 0 here (the kernel leaves them unwritten).'''
    return twopass_tap_lists_plain(M[:, :, :P].transpose(1, 2), M.shape[1])


def _gather_taps(z, count, idx, val):
    '''dv[b, c, l, s] = sum over k < count[b, l], ascending, of
    val[b, l, k] z[b, c, idx[b, l, k], s]: M^T z from M's tap lists.'''
    B, C, _, S = z.shape
    P = count.shape[1]
    dv = z.new_zeros((B, C, P, S))
    for k in range(int(count.max())):
        live = count > k
        rows = torch.where(live, idx[:, :, k], 0).long()
        taken = z.gather(2, rows[:, None, :, None].expand(B, C, P, S))
        dv = dv + torch.where(live, val[:, :, k], 0.0)[:, None, :, None] * taken
    return dv


def _undouble(dv, t, f, P, n):
    '''The transpose of `_shift_blend` along axis 2 of dv [B, C, P, L]:
    dz(m) = (1-f) dv[(m-t) mod P] + f dv[(m-t-1) mod P], folded onto
    n lines through the mirror: dz(i) + dz(P-i) inside, dz(i) at both ends.'''
    B, C, _, L = dv.shape
    m = torch.arange(P, device=dv.device)[None, :, None]
    i0 = torch.remainder(m - t[:, None, :].long(), P)
    i1 = torch.remainder(i0 - 1, P)
    f = f[:, None, None, :]
    dz = ((1 - f) * dv.gather(2, i0[:, None].expand(B, C, P, L))
          + f * dv.gather(2, i1[:, None].expand(B, C, P, L)))
    inner = dz[:, :, P - torch.arange(1, n - 1, device=dv.device)]
    return torch.cat([dz[:, :, :1], dz[:, :, 1:n - 1] + inner, dz[:, :, n - 1:n]], dim=2)


def twopass_bwd_lists_plain(g, t1, f1, t2, f2, lists1, lists2, P1, P2, We):
    '''dx [B, C, N, Wep] from g [B, C, out, N] and the tap lists of M1 and
    M2 ((count, idx, val) each, as `twopass_tap_lists_plain` gives them),
    in the kernel chain's order: stage A (M2^T g by the lists, then the
    pass-2 blend/shift transposes and mirror undoubling, per row), then
    stage B (the same along the columns with M1); zero in columns >= We.'''
    N, Wep = g.shape[3], t1.shape[1]
    dy1 = _undouble(_gather_taps(g, *lists2), t2, f2, P2, We).transpose(2, 3)
    dx = _undouble(_gather_taps(dy1, *lists1), t1[:, :We], f1[:, :We], P1, N)
    return torch.nn.functional.pad(dx, (0, Wep - We))


def twopass_fwd_lists_plain(x, t1, f1, t2, f2, rows1, rows2, P1, P2, We, out_len):
    '''out [B, C, out_len, N] from x [B, C, N, Wep] and the row lists of M1
    and M2 ((count, idx, val) each, as `twopass_row_lists_plain` gives
    them), in the fused kernel's order: pass 1 (each row's taps of the
    blended, shifted canvas, ascending), then pass 2 (the same along y1's
    rows with M2).'''
    N = x.shape[2]
    y1 = _gather_taps(_shift_blend(x, t1, f1, P1, N), *rows1)[..., :We]
    return _gather_taps(_shift_blend(y1.transpose(2, 3), t2, f2, P2, We), *rows2)[:, :, :out_len]


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


def _lists(B, n, k, device):
    '''Scratch for one list set: counts [B, n] int32, idx and val [B, n, k].'''
    return (torch.empty((B, n), dtype=torch.int32, device=device),
            torch.empty((B, n, k), dtype=torch.int32, device=device),
            torch.empty((B, n, k), dtype=torch.float32, device=device))


def _launch_fwd(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
    '''The forward kernels: out, and the row lists they built, (count,
    idx, val) of M1 and of M2.'''
    global fwd_launches
    lib = _library('ada_twopass')
    dims = _dims(x, M1, M2, P1, P2, We, out_len)
    B, C, N, _ = x.shape
    out = torch.empty((B, C, out_len, N), dtype=torch.float32, device=x.device)
    lists = [_lists(B, R, P, x.device) for R, P in ((N, P1), (out_len, P2))]
    err = lib.ada_twopass_fwd(
        x.data_ptr(), t1.data_ptr(), f1.data_ptr(), M1.data_ptr(),
        t2.data_ptr(), f2.data_ptr(), M2.data_ptr(), out.data_ptr(),
        *(a.data_ptr() for row_lists in lists for a in row_lists), *dims,
        torch.cuda.current_stream(x.device).cuda_stream)
    if err:
        raise RuntimeError(f'ada_twopass_fwd failed: CUDA error {err} '
                           f'(shared memory {lib.ada_twopass_smem_bytes(*dims)} B)')
    fwd_launches += 1
    return out, *lists


def _launch_bwd(g, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
    '''The backward kernel chain: dx, and the tap lists it built,
    (count, idx, val) of M1 and of M2.'''
    global bwd_launches
    lib = _library('ada_twopass')
    g = g.contiguous()
    B, C, _, N = g.shape
    Wep = t1.shape[1]
    dims = [B, C, N, Wep, We, P1, M1.shape[2], P2, M2.shape[2], out_len]
    f32 = dict(dtype=torch.float32, device=g.device)
    dx = torch.empty((B, C, N, Wep), **f32)
    dy1 = torch.empty((B, C, N, We), **f32)
    lists = [_lists(B, P, R, g.device) for P, R in ((P1, N), (P2, out_len))]
    err = lib.ada_twopass_bwd(
        g.data_ptr(), t1.data_ptr(), f1.data_ptr(), M1.data_ptr(),
        t2.data_ptr(), f2.data_ptr(), M2.data_ptr(), dx.data_ptr(), dy1.data_ptr(),
        *(a.data_ptr() for tap_lists in lists for a in tap_lists), *dims,
        torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f'ada_twopass_bwd failed: CUDA error {err} '
                           f'(shared memory {lib.ada_twopass_smem_bytes(*dims)} B)')
    bwd_launches += 1
    return dx, *lists


class _TwoPassFused(torch.autograd.Function):
    '''Forward kernel; backward kernel chain (first order only: R1 skips
    augmentation and the path-length penalty never reaches D).'''

    @staticmethod
    def forward(ctx, x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len):
        ctx.save_for_backward(t1, f1, M1, t2, f2, M2)
        ctx.dims = (P1, P2, We, out_len)
        return _launch_fwd(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        t1, f1, M1, t2, f2, M2 = ctx.saved_tensors
        dx = _launch_bwd(g, t1, f1, M1, t2, f2, M2, *ctx.dims)[0]
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


# ---------------------------------------------------------------------------
# one line pass (`csrc/ada_linepass.cu`)
# ---------------------------------------------------------------------------

def linepass_fused_plain(z, t, f, M):
    '''The line kernels' function in plain PyTorch (differentiable by
    autograd): shift, blend and M product along axis 2 of z.'''
    N = z.shape[2]
    P = 2 * N - 2
    v = _shift_blend(z, t, f, P, N)                              # [B,C,P,W]
    return torch.einsum('bol,bclw->bcow', M[:, :, :P], v)


def linepass_fwd_lists_plain(z, t, f, rows):
    '''out [B, C, out, W] from z [B, C, N, W] and the row lists of M
    ((count, idx, val), as `twopass_row_lists_plain` gives them), in the
    fused kernel's order: each output line's taps of the blended, shifted
    lines, ascending.'''
    N = z.shape[2]
    return _gather_taps(_shift_blend(z, t, f, 2 * N - 2, N), *rows)


def linepass_bwd_lists_plain(g, t, f, cols, N):
    '''dz [B, C, N, W] from g [B, C, out, W] and the tap lists of M
    ((count, idx, val), as `twopass_tap_lists_plain` gives them), in the
    gather kernel's order: M^T g by the lists, then the blend and shift
    transposes and the mirror undoubling onto N lines.'''
    return _undouble(_gather_taps(g, *cols), t, f, 2 * N - 2, N)


def _check_line(z, t, f, M):
    B, C, N, W = z.shape
    for name, tensor, dtype, shape in (
            ('z', z, torch.float32, None), ('t', t, torch.int32, (B, W)),
            ('f', f, torch.float32, (B, W)), ('M', M, torch.float32, None)):
        if tensor.device != z.device:
            raise ValueError(f'{name} is on {tensor.device}, z on {z.device}')
        if tensor.dtype != dtype:
            raise TypeError(f'{name} must be {dtype}, got {tensor.dtype}')
        if shape is not None and tuple(tensor.shape) != shape:
            raise ValueError(f'{name} has shape {tuple(tensor.shape)}, '
                             f'expected {shape}')
        if not tensor.is_contiguous():
            raise ValueError(f'{name} must be contiguous')
    if N < 2 or M.ndim != 3 or M.shape[0] != B or M.shape[2] < 2 * N - 2:
        raise ValueError(f'M has shape {tuple(M.shape)}; expected [{B}, out, >= '
                         f'{2 * N - 2}] for z {tuple(z.shape)}')


def _line_dims(z, M):
    B, C, N, W = z.shape
    return [B, C, N, W, 2 * N - 2, M.shape[2], M.shape[1]]


def _launch_line_fwd(z, t, f, M):
    '''The forward kernels: out, and the row lists of M they built,
    (count, idx, val).'''
    global line_fwd_launches
    lib = _library('ada_linepass')
    dims = _line_dims(z, M)
    B, C, N, W = z.shape
    out = torch.empty((B, C, M.shape[1], W), dtype=torch.float32, device=z.device)
    rows = _lists(B, M.shape[1], 2 * N - 2, z.device)
    err = lib.ada_linepass_fwd(z.data_ptr(), t.data_ptr(), f.data_ptr(), M.data_ptr(),
                               out.data_ptr(), *(a.data_ptr() for a in rows), *dims,
                               torch.cuda.current_stream(z.device).cuda_stream)
    if err:
        raise RuntimeError(f'ada_linepass_fwd failed: CUDA error {err} '
                           f'(shared memory {lib.ada_linepass_smem_bytes(*dims)} B)')
    line_fwd_launches += 1
    return out, rows


def _launch_line_bwd(g, t, f, M, N):
    '''The backward kernels: dz, and the tap lists of M they built,
    (count, idx, val).'''
    global line_bwd_launches
    lib = _library('ada_linepass')
    B, C, out_len, W = g.shape
    P = 2 * N - 2
    dims = [B, C, N, W, P, M.shape[2], out_len]
    dz = torch.empty((B, C, N, W), dtype=torch.float32, device=g.device)
    cols = _lists(B, P, out_len, g.device)
    err = lib.ada_linepass_bwd(g.data_ptr(), t.data_ptr(), f.data_ptr(), M.data_ptr(),
                               dz.data_ptr(), *(a.data_ptr() for a in cols), *dims,
                               torch.cuda.current_stream(g.device).cuda_stream)
    if err:
        raise RuntimeError(f'ada_linepass_bwd failed: CUDA error {err} '
                           f'(shared memory {lib.ada_linepass_smem_bytes(*dims)} B)')
    line_bwd_launches += 1
    return dz, cols


class _LinePassFused(torch.autograd.Function):
    '''Forward kernel; backward kernel (first order only, into z).'''

    @staticmethod
    def forward(ctx, z, t, f, M):
        ctx.save_for_backward(t, f, M)
        ctx.N = z.shape[2]
        return _launch_line_fwd(z, t, f, M)[0]

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        t, f, M = ctx.saved_tensors
        return _launch_line_bwd(g.contiguous(), t, f, M, ctx.N)[0], None, None, None


def linepass_fused(z, t, f, M):
    '''One line pass; the CUDA kernels for a CUDA tensor, the plain version
    for a CPU tensor.'''
    if z.device.type == 'cpu':
        return linepass_fused_plain(z, t, f, M)
    if z.device.type != 'cuda':
        raise ValueError(f'linepass_fused runs on cuda or cpu, not {z.device}')
    _check_line(z, t, f, M)
    return _LinePassFused.apply(z, t, f, M)
