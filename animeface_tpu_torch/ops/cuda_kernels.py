'''Hand-written CUDA kernels of the ops registry's 'cuda' implementation.

Counterpart of `animeface_tpu/ops/pallas_kernels.py`. Two kernels, each with
its plain PyTorch version beside it, its scope test and a launch counter:

* `bias_act` (`csrc/bias_act.cu`) replaces `bias_act_pallas`
  (`_bias_act_kernel`): bias, activation, gain and clamp in f32, rounded
  once to x's dtype. Scope (`bias_act_in_scope`), as in the JAX package: a
  bias on the channel axis, C % 128 == 0, numel / C a multiple of 8. The
  bias may be f32 with a bf16 x: kernel and plain version round it to x's
  dtype first. The layout and grid come from `bias_act_layout`; the
  wrapper keeps each call signature's parameter block, so a repeated call
  costs a dictionary lookup, an allocation and one five-argument ctypes
  call on the host.
* `filtered_lrelu` (`csrc/filtered_lrelu.cu`) replaces the three variants
  of `filtered_lrelu_pallas` (`_flrelu_kernel`, `_flrelu_kernel_gather`,
  `_flrelu_kernel_shift`) with one kernel: bias, 2x up-FIR, leaky ReLU x
  gain, clamp, 2x down-FIR, the 2x intermediate in shared memory only, f32
  inside, one rounding. Scope (`filtered_lrelu_in_scope`), as
  `_flrelu_config`: up = down = 2, 1-D filters, non-negative padding,
  C % 128 == 0, out_h == H and out_h % 8 == 0 (NCHW here, NHWC in JAX).
  Filters of up to 24 taps run a kernel compiled for their size class
  (`filtered_lrelu_size_class`), with the taps passed by value as
  `filtered_lrelu_taps` orders them; longer ones run a loop kernel that
  reads its taps from memory. `filtered_lrelu_phases_plain` is the
  templated kernel's polyphase order in plain PyTorch, for the tests.

Both are forward only, as the Pallas kernels are: a CUDA tensor that
requires grad while grad is enabled raises. A CPU tensor takes the plain
version; a CUDA tensor launches the kernel or raises, and never falls back.
`filtered_lrelu`'s bias arrives in x's dtype, as the Pallas entry points
cast it.
'''

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from animeface_tpu_torch.ops.activations import activation_funcs
from animeface_tpu_torch.ops.upfirdn2d import upfirdn2d

#: launches of each kernel, counted by the wrappers below (a run can show
#: that it went through the kernels)
bias_act_launches = 0
filtered_lrelu_launches = 0

#: the kernel's index of each activation (`enum Act` in csrc/bias_act.cu)
ACT_INDEX = {name: i for i, name in enumerate(
    ('linear', 'relu', 'lrelu', 'tanh', 'sigmoid', 'elu', 'selu', 'softplus', 'swish'))}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_p, _i, _ll, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    'bias_act': [('bias_act_fwd', [_p] * 5)],
    'filtered_lrelu': [('filtered_lrelu_fwd', [_p] * 5 + [_i] * 12 + [_f] * 3 + [_p])],
}
_libs = {}


def _library(source):
    lib = _libs.get(source)
    if lib is None:
        from animeface_tpu_torch._build import library
        lib = library(source)
        for name, argtypes in _SIGNATURES[source]:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _libs[source] = lib
    return lib


_FORWARD_ONLY = ("{}: the CUDA kernel is forward only (as the JAX package's Pallas kernel); "
                 "run it under torch.no_grad() or use impl='torch'")


def _check_cuda(name, x, *others):
    '''What a kernel wrapper refuses on a CUDA tensor: no backward exists,
    the kernels take f32 and bf16 contiguous tensors on x's card.'''
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, *others)):
        raise RuntimeError(_FORWARD_ONLY.format(name))
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f'{name}: x must be float32 or bfloat16, got {x.dtype}')
    if not x.is_contiguous():
        raise ValueError(f'{name}: x must be contiguous')
    for t in others:
        if t is not None and t.device != x.device:
            raise ValueError(f'{name}: an argument is on {t.device}, x on {x.device}')


def _stream(x):
    return torch.cuda.current_stream(x.device).cuda_stream


# ---------------------------------------------------------------- bias_act

def bias_act_in_scope(x_shape, b, dim) -> bool:
    '''The kernel's scope (`bias_act_pallas`'s): a bias along `dim` with
    C % 128 == 0 entries, and numel / C a multiple of 8.'''
    if b is None or b.ndim != 1:
        return False
    C = x_shape[dim % len(x_shape)]
    return C > 0 and C % 128 == 0 and b.shape[0] == C and math.prod(x_shape) // C % 8 == 0


#: threads a block at most (kThreads in csrc/bias_act.cu); the largest grid_x
BIAS_ACT_THREADS, BIAS_ACT_MAX_GRID_X = 256, 2 ** 31 - 1
#: the kernel's layouts, by index (`enum Mode`)
BIAS_ACT_MODES = ('rows', 'planes', 'scalar')


class BiasActLayout(NamedTuple):
    '''How the kernel covers x: its mode (of BIAS_ACT_MODES), n elements,
    C bias entries, `inner` elements after the bias axis, `rows` (the rows
    mode's n / C rows, the planes mode's n / inner planes, else n), and the
    launch's grid and block, (x, y) each.'''
    mode: str
    n: int
    C: int
    inner: int
    rows: int
    grid: tuple
    block: tuple


def _ceil(a, b):
    return -(-a // b)


def bias_act_layout(shape, dim, itemsize, aligned) -> BiasActLayout:
    '''The kernel's layout for a contiguous x of `shape` with the bias on
    `dim`, elements of `itemsize` bytes, x 16-byte `aligned` or not. With
    V = 16 / itemsize values a vector:
      * 'rows' when aligned, inner == 1 and V divides C: block_x threads
        take the row's C / V vectors (a row wider than 256 vectors split
        evenly over grid_y, block_x then a multiple of 32), block_y rows
        fill the block, grid_x covers the rows;
      * 'planes' when aligned and V divides inner: block_x threads (32 to
        256) take a plane's inner / V vectors, block_y planes fill the
        block, grid_y covers a plane's vectors, grid_x the planes;
      * 'scalar' otherwise: 256 threads, one element each.
    A thread takes one vector (one element) a step; the grid covers x in
    one step where its limits allow, and blocks loop where they do not.'''
    dim %= len(shape)
    C, inner, n = shape[dim], math.prod(shape[dim + 1:]), math.prod(shape)
    if n == 0:
        raise ValueError('bias_act: the kernel takes no empty x')
    V = 16 // itemsize
    if aligned and inner == 1 and C % V == 0:
        cv = C // V
        gy = _ceil(cv, BIAS_ACT_THREADS)
        bx = cv if gy == 1 else _ceil(_ceil(cv, gy), 32) * 32
        by = BIAS_ACT_THREADS // bx
        rows = n // C
        return BiasActLayout('rows', n, C, inner, rows,
                             (min(_ceil(rows, by), BIAS_ACT_MAX_GRID_X), gy), (bx, by))
    if aligned and inner % V == 0:
        iv = inner // V
        bx = min(BIAS_ACT_THREADS, _ceil(iv, 32) * 32)
        by = BIAS_ACT_THREADS // bx
        planes = n // inner
        return BiasActLayout('planes', n, C, inner, planes,
                             (min(_ceil(planes, by), BIAS_ACT_MAX_GRID_X),
                              min(_ceil(iv, bx), 65535)), (bx, by))
    return BiasActLayout('scalar', n, C, inner, n,
                         (min(_ceil(n, BIAS_ACT_THREADS), BIAS_ACT_MAX_GRID_X), 1),
                         (BIAS_ACT_THREADS, 1))


class _BiasActParams(ctypes.Structure):
    '''`struct BiasActParams` of csrc/bias_act.cu.'''
    _fields_ = [('n', _ll), ('C', _ll), ('inner', _ll), ('rows', _ll),
                ('mode', _i), ('dtype', _i), ('bias_f32', _i), ('act', _i),
                ('alpha', _f), ('gain', _f), ('clamp', _f),
                ('grid_x', _i), ('grid_y', _i), ('block_x', _i), ('block_y', _i)]


#: call signature -> (parameter block, its address); the launch function
#: and the raw-stream getter, bound at the first plan
_bias_act_plans = {}
_bias_act_fwd = _raw_stream = None


def _bias_act_plan(shape, dtype, b_shape, b_dtype, dim, act, alpha, gain, clamp, aligned):
    '''The parameter block of one call signature (checked once, here).'''
    global _bias_act_fwd, _raw_stream
    if dtype not in _DTYPE_CODE:
        raise TypeError(f'bias_act: x must be float32 or bfloat16, got {dtype}')
    C = shape[dim % len(shape)]
    if b_shape != (C,):
        raise ValueError(f'bias_act: the kernel needs a bias of {C} entries along dim {dim}, '
                         f'got {tuple(b_shape)}')
    lay = bias_act_layout(shape, dim, dtype.itemsize, aligned)
    params = _BiasActParams(lay.n, lay.C, lay.inner, lay.rows, BIAS_ACT_MODES.index(lay.mode),
                            _DTYPE_CODE[dtype], b_dtype == torch.float32, ACT_INDEX[act],
                            alpha, gain, clamp, *lay.grid, *lay.block)
    _bias_act_fwd = _library('bias_act').bias_act_fwd
    _raw_stream = torch._C._cuda_getCurrentRawStream
    if len(_bias_act_plans) >= 4096:
        _bias_act_plans.clear()
    plan = _bias_act_plans[(shape, dtype, b_shape, b_dtype, dim, act, alpha, gain, clamp,
                            aligned)] = (params, ctypes.addressof(params))
    return plan


def bias_act_plain(x, b, dim, act, alpha, gain, clamp):
    '''The kernel's function in plain PyTorch: x + b along `dim` in f32,
    the activation, times `gain`, clipped to [-clamp, clamp] when
    clamp >= 0, rounded once to x's dtype.'''
    shape = [1] * x.ndim
    shape[dim % x.ndim] = -1
    v = x.float() + b.to(x.dtype).float().reshape(shape)
    v = activation_funcs[act].func(v, alpha=alpha)
    if gain != 1:
        v = v * gain
    if clamp >= 0:
        v = v.clamp(-clamp, clamp)
    return v.to(x.dtype)


def bias_act(x, b, dim, act, alpha, gain, clamp):
    '''`bias_act_plain`; the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. `clamp` < 0 means no clamp. `b` is f32 or of
    x's dtype (another dtype is cast first); the kernel rounds it to x's.'''
    global bias_act_launches
    if not x.is_cuda:
        if x.device.type == 'cpu':
            return bias_act_plain(x, b, dim, act, alpha, gain, clamp)
        raise ValueError(f'bias_act runs on cuda or cpu, not {x.device}')
    if b is None:
        raise ValueError('bias_act: the kernel needs a bias')
    if torch.is_grad_enabled() and (x.requires_grad or b.requires_grad):
        raise RuntimeError(_FORWARD_ONLY.format('bias_act'))
    if not x.is_contiguous():
        raise ValueError('bias_act: x must be contiguous')
    if b.dtype is not x.dtype and b.dtype is not torch.float32 or not b.is_contiguous():
        b = b.to(x.dtype).contiguous()
    device = x.get_device()
    if b.get_device() != device:
        raise ValueError(f'bias_act: the bias is on {b.device}, x on {x.device}')
    key = (x.shape, x.dtype, b.shape, b.dtype, dim, act, alpha, gain, clamp,
           x.data_ptr() % 16 == 0)
    plan = _bias_act_plans.get(key) or _bias_act_plan(*key)
    y = torch.empty_like(x)
    err = _bias_act_fwd(x.data_ptr(), b.data_ptr(), y.data_ptr(), plan[1], _raw_stream(device))
    if err:
        raise RuntimeError(f'bias_act_fwd failed: CUDA error {err}')
    bias_act_launches += 1
    return y


# ---------------------------------------------------------- filtered_lrelu

def _out_size(size, pad_lo, pad_hi, Lu, Ld):
    return (size * 2 + pad_lo + pad_hi - (Lu - 1) - (Ld - 1) + 1) // 2


def filtered_lrelu_in_scope(x_shape, fu, fd, up, down, padding) -> bool:
    '''The kernel's scope (`_flrelu_config`'s) for NCHW `x_shape` and
    padding (px0, px1, py0, py1).'''
    if up != 2 or down != 2 or fu is None or fd is None:
        return False
    if fu.ndim != 1 or fd.ndim != 1:
        return False
    px0, px1, py0, py1 = padding
    if min(px0, px1, py0, py1) < 0:
        return False
    _, C, H, _ = x_shape
    if C % 128 != 0:
        return False
    out_h = _out_size(H, py0, py1, fu.shape[0], fd.shape[0])
    return out_h == H and out_h % 8 == 0


def filtered_lrelu_plain(x, fu, fd, b, padding, gain, slope, clamp):
    '''The kernel's function in plain PyTorch (up = down = 2, NCHW): the
    'store' composition of ops/filtered_lrelu.py in f32, rounded once to
    x's dtype. `clamp` is None or >= 0.'''
    v = x.float()
    if b is not None:
        v = v + b.to(x.dtype).float().reshape(1, -1, 1, 1)
    v = upfirdn2d(v, fu, up=2, padding=padding, gain=4)
    v = torch.nn.functional.leaky_relu(v, slope)
    if gain != 1:
        v = v * gain
    if clamp is not None:
        v = v.clamp(-clamp, clamp)
    return upfirdn2d(v, fd, down=2).to(x.dtype)


#: the filter lengths a templated kernel is compiled for (`Taps<K>` in
#: csrc/filtered_lrelu.cu); both filters are zero-padded at their end to K
FLRELU_SIZE_CLASSES = (12, 24)


def filtered_lrelu_size_class(Lu, Ld):
    '''The K of the templated kernel that takes Lu up and Ld down taps, or
    None past the largest class (the loop kernel).'''
    return next((K for K in FLRELU_SIZE_CLASSES if max(Lu, Ld) <= K), None)


def _on_host(f):
    '''f on the host. A filter on the card is read back once and kept on the
    tensor until it is modified in place (its version changes), so a call
    does not wait for the card. (Writes through `.data` keep the version.)'''
    if f.device.type == 'cpu':
        return f
    memo = getattr(f, '_flrelu_host_copy', None)
    if memo is None or memo[0] != f._version:
        memo = (f._version, f.detach().cpu())
        f._flrelu_host_copy = memo
    return memo[1]


def filtered_lrelu_taps(fu, fd, px0, py0, K):
    '''The templated kernel's taps, `struct Taps<K>`: 3K f32 values on the
    CPU, the up taps split by phase along H (K), then along W (K), then
    the down taps (K).

    gu = flip(fu) * 2 (the up gain 4, split over the two axes) and
    gd = flip(fd), each zero-padded at its end to K. Of the zero-inserted
    input only the taps whose parity matches a y row's meet a sample, so
    row m (and likewise column n with px0) sums K / 2 taps of its phase:
        y[m] = sum_{j < K/2} up_h[m % 2][j] * xb[ceil((m - py0) / 2) + j],
        up_h[r][j] = gu[(py0 - r) % 2 + 2 j],
    and the down-FIR is out[k] = sum_{a < K} gd[a] * e[2 k + a]. A zero
    tap appended at the end adds no term.'''
    Lu, Ld = fu.shape[0], fd.shape[0]
    if K % 2 or max(Lu, Ld) > K:
        raise ValueError(f'filtered_lrelu_taps: {Lu} and {Ld} taps for K = {K}')
    gu = torch.zeros(K + 1)
    gu[:Lu] = _on_host(fu).float().flip(0) * 2
    gd = torch.zeros(K)
    gd[:Ld] = _on_host(fd).float().flip(0)
    phases = [gu[(p0 - r) % 2::2][:K // 2] for p0 in (py0, px0) for r in (0, 1)]
    return torch.cat(phases + [gd]).contiguous()


def _up_phases(v, up, pad0, n):
    '''y[m] for m < n along the last axis of v (f32) from the phase taps
    `up` [2, K/2], the input zero outside v.'''
    half, L = up.shape[1], v.shape[-1]
    lo = pad0 // 2                        # -ceil((0 - pad0) / 2)
    hi = max(0, -(-(n - 1 - pad0) // 2) + half - L)
    vp = torch.nn.functional.pad(v, (lo, hi))
    y = v.new_empty(v.shape[:-1] + (n,))
    for r in (0, 1):
        count = (n - r + 1) // 2
        start = lo - (pad0 - r) // 2      # ceil((r - pad0) / 2), in vp
        acc = torch.zeros_like(vp[..., :count])
        for j in range(half):
            acc = acc + up[r, j] * vp[..., start + j:start + j + count]
        y[..., r::2] = acc
    return y


def _down(v, gd, n):
    '''out[k] = sum_a gd[a] * v[2 k + a] for k < n along the last axis.'''
    K = gd.shape[0]
    vp = torch.nn.functional.pad(v, (0, max(0, 2 * n + K - 2 - v.shape[-1])))
    acc = torch.zeros_like(vp[..., :n])
    for a in range(K):
        acc = acc + gd[a] * vp[..., a:a + 2 * n - 1:2]
    return acc


def filtered_lrelu_phases_plain(x, fu, fd, b, padding, gain, slope, clamp):
    '''`filtered_lrelu_plain` in the templated kernel's order: taps from
    `filtered_lrelu_taps` padded to the size class (past 24 taps, to the
    next even length), then the four separable polyphase stages with no
    zero insertion (up along H, up along W with the activation, gain and
    clamp, down along W, down along H) over the 2 * out + K - 2 rows and
    columns of y the down-FIR reads, in f32, rounded once. For tests.'''
    px0, px1, py0, py1 = padding
    N, C, H, W = x.shape
    Lu, Ld = fu.shape[0], fd.shape[0]
    K = filtered_lrelu_size_class(Lu, Ld) or max(Lu, Ld) + max(Lu, Ld) % 2
    taps = filtered_lrelu_taps(fu, fd, px0, py0, K).to(x.device)
    up_h, up_w = taps[:K].reshape(2, -1), taps[K:2 * K].reshape(2, -1)
    gd = taps[2 * K:]
    OH, OW = _out_size(H, py0, py1, Lu, Ld), _out_size(W, px0, px1, Lu, Ld)
    v = x.float()
    if b is not None:
        v = v + b.to(x.dtype).float().reshape(1, -1, 1, 1)
    v = _up_phases(v.transpose(2, 3), up_h, py0, 2 * OH + K - 2).transpose(2, 3)
    v = _up_phases(v, up_w, px0, 2 * OW + K - 2)
    v = torch.where(v >= 0, v, v * slope) * gain
    if clamp is not None:
        v = v.clamp(-clamp, clamp)
    v = _down(v, gd, OW)
    return _down(v.transpose(2, 3), gd, OH).transpose(2, 3).to(x.dtype)


def filtered_lrelu(x, fu, fd, b, padding, gain, slope, clamp):
    '''`filtered_lrelu_plain`; the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. The templated kernel takes its taps by value,
    from the filters' host copies (`_on_host`).'''
    global filtered_lrelu_launches
    if x.device.type == 'cpu':
        return filtered_lrelu_plain(x, fu, fd, b, padding, gain, slope, clamp)
    if x.device.type != 'cuda':
        raise ValueError(f'filtered_lrelu runs on cuda or cpu, not {x.device}')
    _check_cuda('filtered_lrelu', x, b)
    px0, px1, py0, py1 = padding
    if x.ndim != 4 or fu.ndim != 1 or fd.ndim != 1 or min(padding) < 0:
        raise ValueError('filtered_lrelu: the kernel takes NCHW x, 1-D filters and '
                         f'non-negative padding, got {tuple(x.shape)}, {tuple(fu.shape)}, '
                         f'{tuple(fd.shape)}, {padding}')
    N, C, H, W = x.shape
    Lu, Ld = fu.shape[0], fd.shape[0]
    OH, OW = _out_size(H, py0, py1, Lu, Ld), _out_size(W, px0, px1, Lu, Ld)
    if b is not None:
        if b.shape != (C,):
            raise ValueError(f'filtered_lrelu: bias of shape {tuple(b.shape)} for {C} channels')
        b = b.to(x.dtype).contiguous()
    lib = _library('filtered_lrelu')
    K = filtered_lrelu_size_class(Lu, Ld)
    if K is None:       # the loop kernel: gu then gd on the card, oriented as in the header
        taps = torch.cat([fu.float().flip(0) * 2, fd.float().flip(0)]).to(x.device).contiguous()
        host_taps = None
    else:               # by value, copied from the host at the launch
        taps, host_taps = None, filtered_lrelu_taps(fu, fd, px0, py0, K)
    out = torch.empty((N, C, OH, OW), dtype=x.dtype, device=x.device)
    err = lib.filtered_lrelu_fwd(
        x.data_ptr(), None if b is None else b.data_ptr(),
        None if taps is None else taps.data_ptr(),
        None if host_taps is None else host_taps.data_ptr(), out.data_ptr(),
        N, C, H, W, OH, OW, Lu, Ld, K or 0, px0, py0, _DTYPE_CODE[x.dtype], gain, slope,
        -1.0 if clamp is None else clamp, _stream(x))
    if err:
        raise RuntimeError(f'filtered_lrelu_fwd failed: CUDA error {err} ({Lu} up and {Ld} '
                           'down taps)')
    filtered_lrelu_launches += 1
    return out
