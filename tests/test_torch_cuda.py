'''CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests import only torch and the port (no JAX), so they also run on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip. The warp kernels sum the same nonzero taps as the
plain version's f32 einsum, in another order, so the tolerance is 1e-4 abs
on unit-scale inputs. The ops registry's kernels (bias_act,
filtered_lrelu) compute in f32 and round once, as their plain versions do:
1e-4 abs in f32, and 1.6e-2 of the output's scale in bf16 (the ops'
documented bf16 tolerance; one rounding step either way).
'''

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from animeface_tpu_torch import ops
from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
from animeface_tpu_torch.ops import cuda_kernels as ck

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _inputs(B, C, N, Wep, We, band, seed, slope=(0.7, 1.4), wrap=False):
    '''Random pass parameters: M banded (|cyclic distance| < 6.5 around a
    line of a slope drawn from `slope`, as `_pass_params` builds it; with
    `wrap`, a line that crosses the end of the period) or dense (band=None).'''
    rng = np.random.default_rng(seed)
    P1, P2 = 2 * N - 2, 2 * We - 2
    P1p, P2p = -(-P1 // 8) * 8, -(-P2 // 8) * 8

    def matrix(rows, P, Pp):
        M = rng.standard_normal((B, rows, Pp)).astype(np.float32)
        if band is not None:
            a = rng.uniform(*slope, (B, 1, 1))
            base = rng.uniform(-P, P, (B, 1, 1))
            if wrap:
                base = P - a * rows / 2
            q = a * np.arange(rows)[None, :, None] + base
            d = np.mod(q - np.arange(Pp)[None, None, :] + P / 2, P) - P / 2
            M = np.where(np.abs(d) < band, M, 0.0).astype(np.float32)
        M[:, :, P:] = 0.0
        return torch.from_numpy(M)

    x = torch.from_numpy(rng.standard_normal((B, C, N, Wep)).astype(np.float32))
    t1 = torch.from_numpy(rng.integers(0, P1, (B, Wep)).astype(np.int32))
    f1 = torch.from_numpy(rng.uniform(0, 1, (B, Wep)).astype(np.float32))
    t2 = torch.from_numpy(rng.integers(0, P2, (B, N)).astype(np.int32))
    f2 = torch.from_numpy(rng.uniform(0, 1, (B, N)).astype(np.float32))
    return (x, t1, f1, matrix(N, P1, P1p), t2, f2, matrix(N, P2, P2p),
            P1, P2, We, N)


TWOPASS_PARAMS = 'B,C,N,Wep,We,band,slope,wrap'
TWOPASS_CASES = [
    (2, 3, 16, 40, 32, 6.5, (0.7, 1.4), False),      # padded canvas columns (Wep > We)
    (2, 3, 24, 48, 48, None, (0.7, 1.4), False),     # dense M: any M gives the right answer
    (4, 3, 256, 384, 384, 6.5, (0.7, 1.4), False),   # the 256px main-path shapes
    (2, 3, 256, 384, 384, 6.5, (0.05, 0.05), False),  # slope 0.05: columns full to the rows
    (2, 3, 256, 384, 384, 6.5, (3.0, 4.0), False),   # slope 3-4: few taps a column, wrapping
    (2, 3, 64, 96, 96, 6.5, (0.7, 1.4), True),       # bands across the cyclic period
]


def _cuda_inputs(cuda, B, C, N, Wep, We, band, slope, wrap):
    args = _inputs(B, C, N, Wep, We, band, seed=N, slope=slope, wrap=wrap)
    return tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)


@pytest.mark.parametrize(TWOPASS_PARAMS, TWOPASS_CASES)
def test_twopass_kernels_match_plain(cuda, B, C, N, Wep, We, band, slope, wrap):
    args = _cuda_inputs(cuda, B, C, N, Wep, We, band, slope, wrap)
    x = args[0].clone().requires_grad_(True)
    ref = agc.twopass_fused_plain(x, *args[1:])
    g = torch.randn_like(ref)
    (gref,) = torch.autograd.grad(ref, x, g)

    xk = args[0].clone().requires_grad_(True)
    before = (agc.fwd_launches, agc.bwd_launches)
    got = agc.twopass_fused(xk, *args[1:])
    (ggot,) = torch.autograd.grad(got, xk, g)
    torch.cuda.synchronize()
    assert (agc.fwd_launches, agc.bwd_launches) == (before[0] + 1, before[1] + 1)
    scale = max(1.0, float(ref.detach().abs().max()))
    assert float((got - ref).abs().max()) < 1e-4 * scale
    gscale = max(1.0, float(gref.abs().max()))
    assert float((ggot - gref).abs().max()) < 1e-4 * gscale
    if Wep > We:
        assert float(ggot[..., We:].abs().max()) == 0.0


@pytest.mark.parametrize(TWOPASS_PARAMS, TWOPASS_CASES)
def test_twopass_tap_lists_match_plain(cuda, B, C, N, Wep, We, band, slope, wrap):
    '''The lists the backward chain builds equal `twopass_tap_lists_plain`
    exactly: counts, rows and values; M's columns past P are not read.'''
    x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len = _cuda_inputs(
        cuda, B, C, N, Wep, We, band, slope, wrap)
    M1[:, :, P1:] = 5.0                       # junk the kernels must not read
    M2[:, :, P2:] = 5.0
    g = torch.randn((B, C, out_len, N), device=cuda)
    _, *lists = agc._launch_bwd(g, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)
    torch.cuda.synchronize()
    for (count, idx, val), M, P in zip(lists, (M1, M2), (P1, P2)):
        want = agc.twopass_tap_lists_plain(M, P)
        keep = torch.arange(idx.shape[2], device=cuda) < count[..., None]
        assert torch.equal(count, want[0])
        assert torch.equal(idx[keep], want[1][keep]) and torch.equal(val[keep], want[2][keep])


@pytest.mark.parametrize(TWOPASS_PARAMS, TWOPASS_CASES)
def test_twopass_row_lists_match_plain(cuda, B, C, N, Wep, We, band, slope, wrap):
    '''The row lists the forward builds equal `twopass_row_lists_plain`
    exactly: counts, columns and values; M's columns past P are not read.
    The output is the plain warp's.'''
    x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len = _cuda_inputs(
        cuda, B, C, N, Wep, We, band, slope, wrap)
    ref = agc.twopass_fused_plain(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)
    M1[:, :, P1:] = 5.0                       # junk the kernels must not read
    M2[:, :, P2:] = 5.0
    out, *lists = agc._launch_fwd(x, t1, f1, M1, t2, f2, M2, P1, P2, We, out_len)
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 1e-4 * max(1.0, float(ref.abs().max()))
    for (count, idx, val), M, P in zip(lists, (M1, M2), (P1, P2)):
        want = agc.twopass_row_lists_plain(M, P)
        keep = torch.arange(idx.shape[2], device=cuda) < count[..., None]
        assert torch.equal(count, want[0])
        assert torch.equal(idx[keep], want[1][keep]) and torch.equal(val[keep], want[2][keep])


def test_twopass_forward_fills_shared_memory(cuda):
    '''At C=3, N=64, We=112 the forward's plan fills the per-block shared
    memory (232448 B on sm_90) up to the 64 B it keeps for the kernel's
    static shared memory; without that margin it would ask for all 232448
    B and the launch would fail. It launches and matches the plain warp.'''
    args = _cuda_inputs(cuda, 2, 3, 64, 112, 112, 6.5, (0.7, 1.4), False)
    dims = agc._dims(args[0], args[3], args[6], *args[7:])
    smem = agc._library('ada_twopass').ada_twopass_smem_bytes(*dims)
    assert 232448 - 64 - 2 * 4 * 32 * 3 < smem <= 232448 - 64
    ref = agc.twopass_fused_plain(*args)
    out = agc._launch_fwd(*args)[0]
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 1e-4 * max(1.0, float(ref.abs().max()))


def test_warp_at_256px_takes_the_twopass_kernels(cuda):
    '''A 256px warp of the default pipe's draws passes the two-pass gate:
    one forward launch (its shifts vary smoothly along the columns, so the
    forward's pass 1 reads staged windows), and the result matches the
    dense warp.'''
    from animeface_tpu_torch.nnutils.ada import make_ada_pipe
    from animeface_tpu_torch.nnutils.ada_geometry import twopass_warp

    gen = torch.Generator(device=cuda).manual_seed(1)
    images = torch.rand((4, 3, 256, 256), generator=gen, device=cuda) * 2 - 1
    captured = {}

    def capture(x, G_inv):                  # keep the draws, skip the warp
        captured['G'] = G_inv
        return x

    pipe = make_ada_pipe()
    pipe._execute_geometry = capture
    pipe(images, 1.0, generator=gen)
    before = (agc.fwd_launches, agc.line_fwd_launches)
    got = twopass_warp(images, captured['G'])
    torch.cuda.synchronize()
    assert (agc.fwd_launches, agc.line_fwd_launches) == (before[0] + 1, before[1])
    want = twopass_warp(images, captured['G'], fused=False)
    assert float((got - want).abs().max()) < 1e-4


def test_twopass_forward_is_deterministic(cuda):
    '''Two forward calls on the same inputs give bitwise-equal outputs
    (gather form, every sum in its list's fixed order).'''
    args = _cuda_inputs(cuda, *TWOPASS_CASES[2])
    assert torch.equal(agc.twopass_fused(*args), agc.twopass_fused(*args))


def test_twopass_backward_is_deterministic(cuda):
    '''Two backward calls on the same inputs give bitwise-equal dx (gather
    form, every sum in its list's fixed order).'''
    args = _cuda_inputs(cuda, *TWOPASS_CASES[2])
    g = torch.randn((4, 3, 256, 256), device=cuda)
    grads = []
    for _ in range(2):
        x = args[0].clone().requires_grad_(True)
        (dx,) = torch.autograd.grad(agc.twopass_fused(x, *args[1:]), x, g)
        grads.append(dx)
    assert torch.equal(grads[0], grads[1])


def test_twopass_kernel_rejects_bad_input(cuda):
    args = _inputs(1, 3, 16, 32, 32, 6.5, seed=0)
    args = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    with pytest.raises(TypeError):
        agc.twopass_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        agc.twopass_fused(args[0], args[1][:, :8], *args[2:])


def _line_inputs(B, C, N, W, out_len, band, seed, Pp=None, smooth=False):
    '''Random line-pass inputs: M banded around a sloped line (as
    `_pass_params` builds it) or dense (band=None), Pp >= P columns; shifts
    random per column, or with `smooth` a shear's (as the warp draws them).'''
    rng = np.random.default_rng(seed)
    P = 2 * N - 2
    Pp = Pp or P
    M = rng.standard_normal((B, out_len, Pp)).astype(np.float32)
    if band is not None:
        q = (rng.uniform(0.7, 1.4, (B, 1, 1)) * np.arange(out_len)[None, :, None]
             + rng.uniform(-P, P, (B, 1, 1)))
        d = np.mod(q - np.arange(Pp)[None, None, :] + P / 2, P) - P / 2
        M = np.where(np.abs(d) < band, M, 0.0).astype(np.float32)
    z = rng.standard_normal((B, C, N, W)).astype(np.float32)
    t = rng.integers(0, P, (B, W)).astype(np.int32)
    if smooth:
        shear = rng.uniform(-0.6, 0.6, (B, 1)) * (np.arange(W) - (W - 1) / 2)
        t = np.mod(np.floor(shear), P).astype(np.int32)
    f = rng.uniform(0, 1, (B, W)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (z, t, f, M))


LINE_PARAMS = 'B,C,N,W,out_len,band,Pp'
LINE_CASES = [
    (2, 3, 16, 24, 16, 6.5, 32),      # M padded past P (ignored columns)
    (2, 1, 20, 40, 13, None, None),   # dense M, out_len != N
    (8, 3, 128, 192, 128, 6.5, None),  # 128px pass 1 (P = 254)
    (8, 3, 192, 128, 128, 6.5, None),  # 128px pass 2 (P = 382)
]


@pytest.mark.parametrize(LINE_PARAMS, LINE_CASES)
def test_linepass_kernels_match_plain(cuda, B, C, N, W, out_len, band, Pp):
    z, t, f, M = (a.to(cuda) for a in _line_inputs(B, C, N, W, out_len, band, N, Pp))
    if Pp:
        M[:, :, 2 * N - 2:] = 5.0            # junk the kernel must not read
    zr = z.clone().requires_grad_(True)
    ref = agc.linepass_fused_plain(zr, t, f, M)
    g = torch.randn_like(ref)
    (gref,) = torch.autograd.grad(ref, zr, g)

    zk = z.clone().requires_grad_(True)
    before = (agc.line_fwd_launches, agc.line_bwd_launches)
    got = agc.linepass_fused(zk, t, f, M)
    (ggot,) = torch.autograd.grad(got, zk, g)
    torch.cuda.synchronize()
    assert (agc.line_fwd_launches, agc.line_bwd_launches) == (before[0] + 1, before[1] + 1)
    scale = max(1.0, float(ref.detach().abs().max()))
    assert float((got - ref).abs().max()) < 1e-4 * scale
    gscale = max(1.0, float(gref.abs().max()))
    assert float((ggot - gref).abs().max()) < 1e-4 * gscale


@pytest.mark.parametrize(LINE_PARAMS, LINE_CASES)
def test_linepass_lists_match_plain(cuda, B, C, N, W, out_len, band, Pp):
    '''The row lists the forward builds equal `twopass_row_lists_plain`,
    and the tap lists the backward builds `twopass_tap_lists_plain`,
    exactly: counts, indices and values; M's columns past P are not read.
    Output and dz are the list-form plain versions' on those lists.'''
    z, t, f, M = (a.to(cuda) for a in _line_inputs(B, C, N, W, out_len, band, N, Pp))
    P = 2 * N - 2
    if Pp:
        M[:, :, P:] = 5.0                    # junk the kernels must not read
    g = torch.randn((B, C, out_len, W), device=cuda)
    out, rows = agc._launch_line_fwd(z, t, f, M)
    dz, cols = agc._launch_line_bwd(g, t, f, M, N)
    torch.cuda.synchronize()
    want_rows, want_cols = agc.twopass_row_lists_plain(M, P), agc.twopass_tap_lists_plain(M, P)
    for (count, idx, val), want in ((rows, want_rows), (cols, want_cols)):
        keep = torch.arange(idx.shape[2], device=cuda) < count[..., None]
        assert torch.equal(count, want[0])
        assert torch.equal(idx[keep], want[1][keep]) and torch.equal(val[keep], want[2][keep])
    ref = agc.linepass_fwd_lists_plain(z, t, f, want_rows)
    assert float((out - ref).abs().max()) < 1e-4 * max(1.0, float(ref.abs().max()))
    dref = agc.linepass_bwd_lists_plain(g, t, f, want_cols, N)
    assert float((dz - dref).abs().max()) < 1e-4 * max(1.0, float(dref.abs().max()))


@pytest.mark.parametrize('N,W', [(128, 192), (192, 128)])
def test_linepass_kernels_are_deterministic(cuda, N, W):
    '''Two forward and two backward calls on the same inputs (the 128px
    pass shapes) give bitwise-equal outputs: every sum in its list's fixed
    order, no atomics.'''
    z, t, f, M = (a.to(cuda) for a in _line_inputs(8, 3, N, W, 128, 6.5, N, smooth=True))
    g = torch.randn((8, 3, 128, W), device=cuda)
    assert torch.equal(agc._launch_line_fwd(z, t, f, M)[0], agc._launch_line_fwd(z, t, f, M)[0])
    assert torch.equal(agc._launch_line_bwd(g, t, f, M, N)[0],
                       agc._launch_line_bwd(g, t, f, M, N)[0])


def _line_fwd_cap(z, M):
    '''The lines of z a staging buffer of the line forward holds: its plan
    (`fwd_plan` in csrc/ada_linepass.cu) is 8 B a column for the shifts and
    blends, and two buffers of cap lines of 32 columns for C channels.'''
    dims = agc._line_dims(z, M)
    smem = agc._library('ada_linepass').ada_linepass_smem_bytes(*dims)
    return smem, (smem - 8 * z.shape[3]) // (2 * 4 * 32 * z.shape[1])


def test_linepass_forward_dense_reads_through_l1(cuda):
    '''Dense M at the 128px pass-2 shape: a tile's taps span all P = 382
    columns, so every chunk's window (at least P + 1 lines) outgrows the
    staging buffers and the forward gathers from z through L1/L2. It
    matches the plain version.'''
    z, t, f, M = (a.to(cuda) for a in _line_inputs(2, 3, 192, 128, 128, None, 5))
    _, cap = _line_fwd_cap(z, M)
    assert 2 * 192 - 2 + 1 > cap
    ref = agc.linepass_fused_plain(z, t, f, M)
    out = agc._launch_line_fwd(z, t, f, M)[0]
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 1e-4 * max(1.0, float(ref.abs().max()))


def test_linepass_forward_fills_shared_memory(cuda):
    '''At the 128px pass-1 shape the forward's plan fills the per-block
    shared memory (232448 B on sm_90) up to the 64 B it keeps for the
    kernel's static shared memory, with buffers of some 300 lines; the
    shear's windows fit them, so the gathers read the staged windows. It
    launches and matches the plain version.'''
    z, t, f, M = (a.to(cuda) for a in _line_inputs(2, 3, 128, 192, 128, 6.5, 6, smooth=True))
    smem, cap = _line_fwd_cap(z, M)
    assert 232448 - 64 - 2 * 4 * 32 * 3 < smem <= 232448 - 64 and cap < 2 * 254
    ref = agc.linepass_fused_plain(z, t, f, M)
    out = agc._launch_line_fwd(z, t, f, M)[0]
    torch.cuda.synchronize()
    assert float((out - ref).abs().max()) < 1e-4 * max(1.0, float(ref.abs().max()))


def test_linepass_kernel_rejects_bad_input(cuda):
    z, t, f, M = (a.to(cuda) for a in _line_inputs(1, 3, 16, 24, 16, 6.5, 0))
    with pytest.raises(TypeError):
        agc.linepass_fused(z.double(), t, f, M)
    with pytest.raises(TypeError):
        agc.linepass_fused(z, t.long(), f, M)
    with pytest.raises(ValueError):
        agc.linepass_fused(z, t[:, :8].contiguous(), f, M)
    with pytest.raises(ValueError):
        agc.linepass_fused(z.transpose(2, 3), t, f, M)
    with pytest.raises(ValueError):
        agc.linepass_fused(z, t, f, M[:, :, :20].contiguous())
    with pytest.raises(ValueError):
        agc.linepass_fused(z, t, f.cpu(), M)


def test_warp_at_128px_takes_the_line_kernels(cuda):
    '''A 128px warp on the card fails the two-pass gate (We = 192): both
    passes launch the line kernels, and the result matches the dense warp.'''
    from animeface_tpu_torch.nnutils.ada import make_ada_pipe
    from animeface_tpu_torch.nnutils.ada_geometry import twopass_warp

    gen = torch.Generator(device=cuda).manual_seed(0)
    images = torch.rand((4, 3, 128, 128), generator=gen, device=cuda) * 2 - 1
    captured = {}

    def capture(x, G_inv):                  # keep the draws, skip the warp
        captured['G'] = G_inv
        return x

    pipe = make_ada_pipe()
    pipe._execute_geometry = capture
    pipe(images, 1.0, generator=gen)
    before = (agc.fwd_launches, agc.line_fwd_launches)
    got = twopass_warp(images, captured['G'])
    torch.cuda.synchronize()
    assert (agc.fwd_launches, agc.line_fwd_launches) == (before[0], before[1] + 2)
    want = twopass_warp(images, captured['G'], fused=False)
    assert float((got - want).abs().max()) < 1e-4


# ------------------------------------------------- the ops registry's kernels

def _err_ok(got, want):
    err = float((got.float() - want.float()).abs().max())
    if want.dtype == torch.float32:
        return err <= 1e-4
    return err <= 1.6e-2 * max(1.0, float(want.float().abs().max()))


@pytest.mark.parametrize('shape,dim,dtype', [
    ((8, 256, 512), -1, torch.bfloat16),    # CIPS StyleLayer layout [B, S^2, C]
    ((16, 512), 1, torch.float32),          # mapping / affines
    ((16, 1024), 1, torch.float32),
    ((4, 128, 5, 5), 1, torch.float32),     # NCHW, inner = 25: one element a thread
    ((4, 128, 4, 4), 1, torch.bfloat16),    # NCHW, inner = 16: one channel a vector
])
def test_bias_act_kernel_matches_plain(cuda, shape, dim, dtype):
    gen = torch.Generator(device=cuda).manual_seed(len(shape))
    x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
    b = torch.randn(shape[dim], generator=gen, device=cuda)
    for act in sorted(ck.ACT_INDEX):
        for clamp in (-1.0, 0.5):
            want = ck.bias_act_plain(x, b, dim, act, 0.2, 1.3, clamp)
            before = ck.bias_act_launches
            got = ck.bias_act(x, b, dim, act, 0.2, 1.3, clamp)
            torch.cuda.synchronize()
            assert ck.bias_act_launches == before + 1
            assert got.dtype == dtype and got.shape == x.shape
            assert _err_ok(got, want), (act, clamp)


def test_bias_act_kernel_honours_the_stream(cuda):
    '''Under `with torch.cuda.stream(s)` the kernel runs on s: it reads x
    only after the work queued on s before it (a spin, then the copy that
    fills x), and its output is right once s is done.'''
    gen = torch.Generator(device=cuda).manual_seed(11)
    src = torch.randn((64, 2048), generator=gen, device=cuda)
    b = torch.randn(2048, generator=gen, device=cuda)
    x = torch.zeros_like(src)
    want = ck.bias_act_plain(src, b, -1, 'lrelu', 0.2, 1.4, -1.0)
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        assert torch._C._cuda_getCurrentRawStream(cuda.index or 0) == s.cuda_stream
        torch.cuda._sleep(50_000_000)               # tens of ms of spinning on s
        x.copy_(src)
        got = ck.bias_act(x, b, -1, 'lrelu', 0.2, 1.4, -1.0)
    s.synchronize()
    assert torch.equal(got, ck.bias_act(src, b, -1, 'lrelu', 0.2, 1.4, -1.0))
    assert _err_ok(got, want)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
def test_bias_act_kernel_misaligned_x_takes_the_scalar_mode(cuda, dtype):
    '''A contiguous view one element into its storage is not 16-byte
    aligned: the layout is the scalar mode, and the output is right.'''
    gen = torch.Generator(device=cuda).manual_seed(12)
    shape = (16, 8, 512)
    base = torch.randn(16 * 8 * 512 + 1, generator=gen, device=cuda).to(dtype)
    x = base[1:].view(shape)
    assert x.is_contiguous() and x.data_ptr() % 16 != 0
    lay = ck.bias_act_layout(x.shape, -1, x.element_size(), x.data_ptr() % 16 == 0)
    assert lay.mode == 'scalar'
    b = torch.randn(512, generator=gen, device=cuda)
    for act in ('linear', 'lrelu', 'swish'):
        got = ck.bias_act(x, b, -1, act, 0.2, 1.3, 0.9)
        assert _err_ok(got, ck.bias_act_plain(x, b, -1, act, 0.2, 1.3, 0.9)), act
        assert torch.equal(got, ck.bias_act(x.clone(), b, -1, act, 0.2, 1.3, 0.9)), act


@pytest.mark.parametrize('shape,dim', [((16, 512), -1), ((8, 256, 512), -1), ((4, 128, 8, 8), 1)])
def test_bias_act_kernel_f32_bias_with_bf16_x(cuda, shape, dim):
    '''An f32 bias with a bf16 x: within tolerance of the plain version,
    and bit for bit the kernel given the bias rounded to bf16.'''
    gen = torch.Generator(device=cuda).manual_seed(13)
    x = torch.randn(shape, generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(shape[dim], generator=gen, device=cuda) * 0.7
    assert not torch.equal(b, b.to(torch.bfloat16).float())
    for act in ('linear', 'lrelu', 'tanh'):
        got = ck.bias_act(x, b, dim, act, 0.2, 1.3, -1.0)
        assert got.dtype == torch.bfloat16
        assert _err_ok(got, ck.bias_act_plain(x, b, dim, act, 0.2, 1.3, -1.0)), act
        assert torch.equal(got, ck.bias_act(x, b.to(torch.bfloat16), dim, act, 0.2, 1.3, -1.0))


def test_bias_act_kernel_alternating_calls(cuda):
    '''Calls that alternate shapes, dtypes, dims, activations, gains,
    clamps and bias dtypes stay right through the wrapper's memo of
    parameter blocks: three rounds, the second in reverse order.'''
    gen = torch.Generator(device=cuda).manual_seed(14)
    cases = []
    for shape, dim, dtype, act, gain, clamp, bf16_bias in [
            ((16, 512), -1, torch.float32, 'linear', 1.0, -1.0, False),
            ((16, 512), -1, torch.float32, 'lrelu', 1.4, -1.0, False),
            ((16, 512), -1, torch.bfloat16, 'lrelu', 1.4, -1.0, True),
            ((16, 512), -1, torch.bfloat16, 'lrelu', 1.4, -1.0, False),
            ((4, 256, 512), -1, torch.bfloat16, 'lrelu', 1.4, 0.8, False),
            ((4, 128, 8, 8), 1, torch.float32, 'sigmoid', 1.0, -1.0, False),
            ((4, 128, 5, 5), 1, torch.bfloat16, 'elu', 2.0, 0.5, True),
            ((16, 1024), 1, torch.float32, 'linear', 1.0, -1.0, False)]:
        x = torch.randn(shape, generator=gen, device=cuda).to(dtype)
        b = torch.randn(shape[dim], generator=gen, device=cuda)
        b = b.to(dtype) if bf16_bias else b
        args = (x, b, dim, act, 0.2, gain, clamp)
        cases.append((args, ck.bias_act_plain(*args)))
    for order in (cases, cases[::-1], cases):
        for args, want in order:
            got = ck.bias_act(*args)
            assert got.shape == want.shape and got.dtype == want.dtype
            assert _err_ok(got, want), args[2:]


def test_bias_act_kernel_repeatable_at_the_big_shape(cuda):
    '''Two calls at CIPS's big shape ([16, 16384, 512] bf16) give
    bitwise-equal outputs: the kernel has no reduction.'''
    gen = torch.Generator(device=cuda).manual_seed(15)
    x = torch.randn((16, 16384, 512), generator=gen, device=cuda).to(torch.bfloat16)
    b = torch.randn(512, generator=gen, device=cuda)
    args = (x, b, -1, 'lrelu', 0.2, 1.4142135, -1.0)
    got, again = ck.bias_act(*args), ck.bias_act(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


HANN = ops.setup_filter(np.hanning(12))


def _flrelu_case(cuda, shape, taps, dtype, bias):
    '''x, fu, fd and b on the card: the 12-tap Hann filter for (12, 12),
    else asymmetric seeded filters of the given lengths.'''
    gen = torch.Generator(device=cuda).manual_seed(shape[2])
    if taps == (12, 12):
        fu = fd = HANN.to(cuda)
    else:
        rng = np.random.default_rng(taps[0])
        fu, fd = (torch.from_numpy((f / f.sum()).astype(np.float32)).to(cuda)
                  for f in (rng.uniform(0.1, 1, taps[0]), rng.uniform(0.1, 1, taps[1])))
    x = (torch.randn(shape, generator=gen, device=cuda) * 2).to(dtype)
    b = torch.randn(shape[1], generator=gen, device=cuda) * 0.3 if bias else None
    return x, fu, fd, b


@pytest.mark.parametrize('shape,taps,padding,dtype,clamp,bias', [
    ((2, 128, 16, 16), (12, 12), (11, 11, 11, 11), torch.float32, 256.0, True),
    ((2, 128, 64, 64), (12, 12), (11, 11, 11, 11), torch.bfloat16, 256.0, True),
    ((1, 128, 40, 40), (12, 12), (11, 11, 11, 11), torch.float32, None, False),
    ((1, 128, 16, 24), (12, 8), (9, 8, 10, 8), torch.float32, 0.8, True),   # asymmetric
    ((1, 128, 24, 24), (24, 24), (23, 22, 23, 22), torch.float32, None, True),  # > 48 KB smem
    # the 12-tap class at each parity of (px0, py0): the phases' windows
    ((1, 128, 16, 40), (12, 12), (10, 11, 11, 11), torch.float32, 0.8, True),   # even px0
    ((1, 128, 40, 16), (12, 12), (11, 12, 10, 12), torch.float32, None, True),  # even py0
    ((2, 128, 24, 24), (12, 12), (10, 13, 10, 11), torch.float32, 0.8, False),  # both even
    ((1, 128, 32, 48), (12, 8), (9, 8, 9, 8), torch.float32, None, True),       # Ld < K, odd
    ((1, 128, 24, 24), (26, 26), (25, 24, 25, 24), torch.float32, 0.8, True),   # loop kernel
    ((1, 128, 272, 272), (12, 12), (11, 11, 11, 11), torch.bfloat16, 256.0, True),  # the path's
])
def test_filtered_lrelu_kernel_matches_plain(cuda, shape, taps, padding, dtype, clamp, bias):
    x, fu, fd, b = _flrelu_case(cuda, shape, taps, dtype, bias)
    want = ck.filtered_lrelu_plain(x, fu, fd, b, padding, 1.4142135, 0.2, clamp)
    before = ck.filtered_lrelu_launches
    got = ck.filtered_lrelu(x, fu, fd, b, padding, 1.4142135, 0.2, clamp)
    torch.cuda.synchronize()
    assert ck.filtered_lrelu_launches == before + 1
    assert got.shape == want.shape and got.dtype == dtype
    assert _err_ok(got, want)


@pytest.mark.parametrize('shape,taps,padding,clamp', [
    ((2, 128, 40, 40), (12, 12), (11, 11, 11, 11), 256.0),
    ((1, 128, 16, 40), (12, 12), (10, 11, 11, 11), 0.8),
    ((1, 128, 40, 16), (12, 12), (11, 12, 10, 12), None),
    ((2, 128, 24, 24), (12, 12), (10, 13, 10, 11), 0.8),
    ((1, 128, 16, 24), (12, 8), (9, 8, 10, 8), 0.8),
    ((1, 128, 24, 24), (24, 24), (22, 23, 23, 22), None),
    ((1, 128, 24, 24), (26, 26), (25, 24, 25, 24), 0.8),
])
def test_filtered_lrelu_kernel_matches_phases_plain(cuda, shape, taps, padding, clamp):
    '''The kernel against `filtered_lrelu_phases_plain`, its own order of
    taps and stages, in f32 (1e-4 abs); two calls give bitwise-equal
    outputs (no atomics, a fixed order of sums).'''
    x, fu, fd, b = _flrelu_case(cuda, shape, taps, torch.float32, True)
    want = ck.filtered_lrelu_phases_plain(x, fu, fd, b, padding, 1.4142135, 0.2, clamp)
    got = ck.filtered_lrelu(x, fu, fd, b, padding, 1.4142135, 0.2, clamp)
    again = ck.filtered_lrelu(x, fu, fd, b, padding, 1.4142135, 0.2, clamp)
    torch.cuda.synchronize()
    assert got.shape == want.shape
    assert _err_ok(got, want)
    assert torch.equal(got, again)


def test_filtered_lrelu_kernel_repeatable_at_path_shape(cuda):
    '''Two calls at the path's geometry (272^2, bf16, padding 11, clamp
    256) give bitwise-equal outputs.'''
    x, fu, fd, b = _flrelu_case(cuda, (2, 128, 272, 272), (12, 12), torch.bfloat16, True)
    args = (x, fu, fd, b, (11,) * 4, 1.4142135, 0.2, 256.0)
    got, again = ck.filtered_lrelu(*args), ck.filtered_lrelu(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, again)


def test_ops_dispatch_by_scope_on_cuda(cuda):
    '''impl='cuda': in-scope calls launch the kernels, out-of-scope calls
    take the composition; the default 'torch' launches nothing.'''
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((4, 128, 16, 16), generator=gen, device=cuda)
    b = torch.randn(128, generator=gen, device=cuda)
    f = HANN.to(cuda)
    counts = (ck.bias_act_launches, ck.filtered_lrelu_launches)
    ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=11, impl='cuda')
    ops.bias_act(x, b, act='lrelu', impl='cuda')
    assert (ck.bias_act_launches, ck.filtered_lrelu_launches) == (counts[0] + 1, counts[1] + 1)
    ops.filtered_lrelu(x[:, :64], f, f, b[:64], up=2, down=2, padding=11, impl='cuda')
    ops.bias_act(x[:, :64], b[:64], act='lrelu', impl='cuda')
    ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=11)
    ops.bias_act(x, b, act='lrelu')
    torch.cuda.synchronize()
    assert (ck.bias_act_launches, ck.filtered_lrelu_launches) == (counts[0] + 1, counts[1] + 1)


def test_kernels_refuse_grad(cuda):
    '''No backward exists: a CUDA tensor that requires grad raises while
    grad is enabled, and runs under torch.no_grad().'''
    x = torch.randn((8, 128, 16, 16), device=cuda, requires_grad=True)
    b = torch.zeros(128, device=cuda)
    f = HANN.to(cuda)
    with pytest.raises(RuntimeError, match='forward only'):
        ops.bias_act(x, b, act='lrelu', impl='cuda')
    with pytest.raises(RuntimeError, match='forward only'):
        ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=11, impl='cuda')
    with torch.no_grad():
        ops.bias_act(x, b, act='lrelu', impl='cuda')
        ops.filtered_lrelu(x, f, f, b, up=2, down=2, padding=11, impl='cuda')
    torch.cuda.synchronize()


# ---------------------------------------------------------- the recipes' CLI

#: small widths at 32px for the DCGAN family, CIPS and FastGAN
CLI_RECIPES = {
    'DCGAN': ('--latent-dim', '8'),
    'GAN': ('--latent-dim', '8'),
    'WGAN': ('--latent-dim', '8'),
    'WGAN_gp': ('--latent-dim', '8'),
    'CIPS': ('--num-layers', '2', '--latent-dim', '128', '--style-dim', '128', '--g-channels',
             '8', '--g-max-channels', '128', '--d-channels', '8', '--d-max-channels', '16'),
    'FastGAN': ('--latent-dim', '8', '--g-channels', '4', '--g-max-channels', '16',
                '--d-channels', '4', '--d-max-channels', '16', '--init-down-size', '32',
                '--decoder-image-size', '16', '--ema'),
}


@pytest.mark.parametrize('recipe', sorted(CLI_RECIPES))
def test_recipe_cli_on_the_card(cuda, tmp_path, recipe):
    '''`python -m animeface_tpu_torch <recipe> --synthetic-data` on the
    card (bf16) for 5 steps, then `--resume` to 6: both exit 0 and leave
    the grids and the last checkpoint.'''
    root = pathlib.Path(__file__).resolve().parents[1]
    out = tmp_path / recipe / 'result'
    argv = [sys.executable, '-m', 'animeface_tpu_torch', recipe, '--synthetic-data',
            '--num-images', '64', '--image-size', '32', '--batch-size', '8', '--save', '5',
            '--log-file', str(tmp_path / 'log.txt'), *CLI_RECIPES[recipe]]
    env = dict(os.environ, ANIMEFACE_IMPLEMENTATIONS_DIR=str(tmp_path))
    env.pop('ANIMEFACE_PLATFORM', None)
    for extra in (['--max-iters', '5'],
                  ['--max-iters', '6', '--resume', str(out / 'checkpoint')]):
        proc = subprocess.run(argv + extra, cwd=root, env=env, capture_output=True, text=True,
                              timeout=600)
        assert proc.returncode == 0, proc.stderr[-4000:]
    assert {'5.png', '6.png', 'G_6.pt'} <= set(os.listdir(out))
    state = torch.load(out / 'checkpoint' / 'ckpt-6' / 'state.pt', weights_only=True)
    assert state['run']['step'] == 6
