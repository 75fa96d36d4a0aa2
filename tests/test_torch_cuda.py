'''CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests import only torch and the port (no JAX), so they also run on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip. The kernels sum the same nonzero taps as the
plain version's f32 einsum, in another order, so the tolerance is 1e-4 abs
on unit-scale inputs.
'''

import numpy as np
import pytest
import torch

from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

pytestmark = pytest.mark.cuda


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _inputs(B, C, N, Wep, We, band, seed):
    '''Random pass parameters: M banded (|cyclic distance| < 6.5 around a
    sloped line, as `_pass_params` builds it) or dense (band=None).'''
    rng = np.random.default_rng(seed)
    P1, P2 = 2 * N - 2, 2 * We - 2
    P1p, P2p = -(-P1 // 8) * 8, -(-P2 // 8) * 8

    def matrix(rows, P, Pp):
        M = rng.standard_normal((B, rows, Pp)).astype(np.float32)
        if band is not None:
            q = (rng.uniform(0.7, 1.4, (B, 1, 1)) * np.arange(rows)[None, :, None]
                 + rng.uniform(-P, P, (B, 1, 1)))
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


@pytest.mark.parametrize('B,C,N,Wep,We,band', [
    (2, 3, 16, 40, 32, 6.5),        # padded canvas columns (Wep > We)
    (2, 3, 24, 48, 48, None),       # dense M: any M gives the right answer
    (4, 3, 256, 384, 384, 6.5),     # the 256px main-path shapes
])
def test_twopass_kernels_match_plain(cuda, B, C, N, Wep, We, band):
    args = _inputs(B, C, N, Wep, We, band, seed=N)
    args = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
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


def test_twopass_kernel_rejects_bad_input(cuda):
    args = _inputs(1, 3, 16, 32, 32, 6.5, seed=0)
    args = tuple(a.to(cuda) if torch.is_tensor(a) else a for a in args)
    with pytest.raises(TypeError):
        agc.twopass_fused(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        agc.twopass_fused(args[0], args[1][:, :8], *args[2:])


def _line_inputs(B, C, N, W, out_len, band, seed, Pp=None):
    '''Random line-pass inputs: M banded around a sloped line (as
    `_pass_params` builds it) or dense (band=None), Pp >= P columns.'''
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
    f = rng.uniform(0, 1, (B, W)).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (z, t, f, M))


@pytest.mark.parametrize('B,C,N,W,out_len,band,Pp', [
    (2, 3, 16, 24, 16, 6.5, 32),      # M padded past P (ignored columns)
    (2, 1, 20, 40, 13, None, None),   # dense M, out_len != N
    (8, 3, 128, 192, 128, 6.5, None),  # 128px pass 1 (P = 254)
    (8, 3, 192, 128, 128, 6.5, None),  # 128px pass 2 (P = 382)
])
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
