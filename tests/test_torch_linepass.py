'''The single-pass ADA line kernel's plain version against the JAX package's
Pallas `linepass_fused` in interpret mode, and the warp's line-kernel
branch (the one 128px takes) against the JAX warp through that kernel.

Same seeded numpy inputs on both sides, f32 on the CPU. Tolerances: the
line pass forward 2e-6 and its gradient 2e-5, the JAX package's own
fused-vs-dense tolerances (tests/test_ada_twopass.py:170-171); 1e-4 for
whole warps and 2e-4 for their gradients, as for the two-pass warp
(tests/test_torch_ada.py): an f32 homography and two passes, summed in
another order.
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.nnutils import ada as jada
from animeface_tpu.nnutils import ada_geometry as jgeo
from animeface_tpu.nnutils.ada_geometry_tpu import linepass_fused as j_linepass_fused
from animeface_tpu_torch.nnutils import ada_geometry as tgeo
from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc


def _line_inputs(N, W, out_len, B=2, C=3, seed=0):
    '''A line pass's inputs as `_pass_params` builds them (banded M).'''
    half, support = jgeo.derive_axis_kernel()
    rng = np.random.default_rng(seed)
    P = 2 * N - 2
    cols = np.arange(W, dtype=np.float32) - (W - 1) / 2
    t, f, M = jgeo._pass_params(
        jnp.asarray(rng.uniform(0.7, 1.3, B), jnp.float32),
        jnp.asarray(rng.uniform(-0.6, 0.6, B), jnp.float32),
        jnp.asarray(rng.uniform(-4, 4, B), jnp.float32), cols, out_len, P, half, support)
    z = rng.standard_normal((B, C, N, W)).astype(np.float32)
    g = rng.standard_normal((B, C, out_len, W)).astype(np.float32)
    return z, np.array(t), np.array(f), np.array(M), g


def _jax_line(z, t, f, M, out_len):
    '''The Pallas kernel on z's padded double canvas, as `_line_pass` calls it.'''
    B, C, N, W = z.shape
    P = 2 * N - 2
    Pp, Wp = -(-P // 8) * 8, -(-W // 128) * 128
    z2 = jgeo._cyclic_double(z, axis=2)
    z2 = jnp.pad(z2, ((0, 0), (0, 0), (0, Pp - P), (0, Wp - W)))
    out = j_linepass_fused(z2, jnp.pad(t, ((0, 0), (0, Wp - W))),
                           jnp.pad(f, ((0, 0), (0, Wp - W))),
                           jnp.pad(M, ((0, 0), (0, 0), (0, Pp - P))), P, out_len, True)
    return out[..., :W]


@pytest.mark.parametrize('N,W,out_len', [
    (16, 24, 16),          # pass 1 of a 16px warp (We = 24)
    (24, 16, 16),          # pass 2: lines along the extended axis
    (12, 40, 9),           # out_len != N
])
def test_plain_linepass_matches_pallas_interpret(N, W, out_len):
    z, t, f, M, g = _line_inputs(N, W, out_len, seed=N)
    fwd = jax.jit(lambda z: _jax_line(z, t, f, M, out_len))
    want = fwd(jnp.asarray(z))
    wgrad = jax.jit(jax.grad(lambda z: jnp.sum(_jax_line(z, t, f, M, out_len) * g)))(
        jnp.asarray(z))

    tz = torch.from_numpy(z).requires_grad_(True)
    got = agc.linepass_fused(tz, torch.from_numpy(t), torch.from_numpy(f),
                             torch.from_numpy(M))
    (ggrad,) = torch.autograd.grad(got, tz, torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6)
    np.testing.assert_allclose(ggrad.numpy(), np.asarray(wgrad), atol=2e-5)


def test_plain_linepass_ignores_padding_columns_of_M():
    '''Columns of M at or beyond P do not contribute (the TPU kernel's
    contract: the caller pads M to Pp).'''
    z, t, f, M, _ = _line_inputs(16, 24, 16)
    args = [torch.from_numpy(a) for a in (z, t, f)]
    padded = np.concatenate([M, np.full(M.shape[:2] + (6,), 7.0, np.float32)], axis=2)
    torch.testing.assert_close(agc.linepass_fused(*args, torch.from_numpy(padded)),
                               agc.linepass_fused(*args, torch.from_numpy(M)),
                               rtol=0, atol=0)


def _images(B=2, N=32, C=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, 8, 8, C)).astype(np.float32)
    x = np.clip(np.asarray(jax.image.resize(x, (B, N, N, C), 'bilinear')), -1, 1)
    return x, torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _maps(B=2):
    '''A rotation, a fractional translation, and aniso scaling after a
    rotation past 90 degrees (exercises the dihedral fold).'''
    return [
        jada.rotate2d_inv(jnp.full((B,), 0.35)),
        jada.translate2d_inv(jnp.asarray([5.25, -1.5]), jnp.asarray([-2.5, 0.75])),
        jada.scale2d_inv(jnp.asarray([1.4, 0.8]), jnp.asarray([0.8, 1.2]))
        @ jada.rotate2d_inv(jnp.full((B,), -1.9)),
    ]


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize('fused', [False, True])
def test_line_branch_warp_matches_jax_line_kernel(monkeypatch, fused):
    '''32px fails the two-pass gate (We = 48), so JAX runs each pass through
    the Pallas line kernel (interpret mode) and the port's kernel branch
    through `linepass_fused` (its plain version on the CPU); `fused=False`
    is the port's dense path. Three transforms and a gradient.'''
    monkeypatch.setenv('ANIMEFACE_ADA_FUSED', '1')
    jx, tx = _images()
    jgeo.derive_axis_kernel()
    warp = jax.jit(jgeo.twopass_warp)
    for G in _maps():
        want = warp(jnp.asarray(jx), G)
        got = tgeo.twopass_warp(tx, torch.from_numpy(np.array(G)), fused=fused)
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4)

    G = _maps()[2]
    wgrad = jax.jit(jax.grad(lambda v: jnp.sum(jnp.square(jgeo.twopass_warp(v, G)))))(
        jnp.asarray(jx))
    x = tx.clone().requires_grad_(True)
    tgeo.twopass_warp(x, torch.from_numpy(np.array(G)), fused=fused).square().sum().backward()
    np.testing.assert_allclose(_nhwc(x.grad), np.asarray(wgrad), atol=2e-4)


def test_line_branch_goes_through_the_wrapper(monkeypatch):
    '''The kernel branch of a gate-failing shape calls `linepass_fused` once
    per pass and never the two-pass wrapper.'''
    calls = []
    monkeypatch.setattr(tgeo, 'linepass_fused',
                        lambda *a: calls.append(a[0].shape) or agc.linepass_fused(*a))
    monkeypatch.setattr(tgeo, 'twopass_fused', None)
    _, tx = _images()
    G = torch.from_numpy(np.array(_maps()[0]))
    out = tgeo.twopass_warp(tx, G, fused=True)
    assert out.shape == tx.shape
    assert calls == [(2, 3, 32, 48), (2, 3, 48, 32)]
