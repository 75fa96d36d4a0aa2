'''CUDA kernels of the port against their plain PyTorch versions, on the card.

These tests import only torch and the port (no JAX), so they also run on a
machine without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card they skip. The kernels sum the same nonzero taps in the same
order as the plain version's f32 einsum up to reassociation, so the
tolerance is 1e-4 abs on unit-scale inputs.
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
