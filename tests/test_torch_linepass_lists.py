'''The line pass in list form: the row lists the CUDA forward builds and the
tap lists the CUDA backward builds (`twopass_row_lists_plain`,
`twopass_tap_lists_plain`), and the plain list-form forward and backward
(`linepass_fwd_lists_plain`, `linepass_bwd_lists_plain`), against the
plain line pass and its autograd and against the JAX package's Pallas
`linepass_fused` in interpret mode.

Inputs: `_line_inputs` of `test_torch_linepass.py` (seeded numpy, f32 on
the CPU, M banded as `_pass_params` builds it) at its three shapes, plus
dense M and M padded past P with junk the lists must not take.
Tolerances: 1e-5 of max(1, the output's scale) against the plain version
and autograd (the same taps and blends, summed in another order); 2e-6
forward and 2e-5 gradient against JAX, the JAX package's own
fused-vs-dense tolerances (tests/test_ada_twopass.py:170-171).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
from test_torch_linepass import _jax_line, _line_inputs

#: (N, W, out_len, M): 'banded' as `_pass_params` builds it, 'dense' (every
#: entry nonzero), 'padded' (banded, with junk columns past P)
CASES = {
    'pass1_16px': (16, 24, 16, 'banded'),      # pass 1 of a 16px warp (We = 24)
    'pass2_16px': (24, 16, 16, 'banded'),      # pass 2: lines along the extended axis
    'out_ne_N': (12, 40, 9, 'banded'),
    'dense': (12, 20, 10, 'dense'),
    'padded': (16, 24, 16, 'padded'),
}


def _inputs(case, seed=0):
    '''z, t, f, M (as the port gets it), M[:, :, :P] (as JAX gets it), g.'''
    N, W, out_len, kind = CASES[case]
    z, t, f, M, g = _line_inputs(N, W, out_len, seed=seed + N)
    if kind == 'dense':
        rng = np.random.default_rng(seed)
        M = rng.uniform(0.1, 1.0, M.shape).astype(np.float32) * rng.choice([-1, 1], M.shape)
    port_M = M
    if kind == 'padded':
        port_M = np.concatenate([M, np.full(M.shape[:2] + (6,), 7.0, np.float32)], axis=2)
    return z, t, f, port_M.astype(np.float32), M.astype(np.float32), g


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _scatter_back(count, idx, val, n, k):
    '''The dense [B, n, k] matrix that a list set (n lists of up to k
    entries) describes.'''
    keep = torch.arange(idx.shape[2]) < count[..., None]
    back = torch.zeros((count.shape[0], n, k))
    back.scatter_add_(2, torch.where(keep, idx, 0).long(), torch.where(keep, val, 0.0))
    return back, keep


@pytest.mark.parametrize('case', sorted(CASES))
def test_row_lists_scatter_back_to_M(case):
    '''The forward's lists: each row's nonzeros among the columns l < P,
    ascending, counted, scattering back to exactly M[:, :, :P].'''
    _, _, _, M, _, _ = _inputs(case)
    M = torch.from_numpy(M)
    N = CASES[case][0]
    P, R = 2 * N - 2, M.shape[1]
    count, idx, val = agc.twopass_row_lists_plain(M, P)
    assert count.dtype == idx.dtype == torch.int32 and val.dtype == torch.float32
    assert count.shape == (M.shape[0], R) and idx.shape == val.shape == (M.shape[0], R, P)
    back, keep = _scatter_back(count, idx, val, R, P)
    assert torch.equal(back, M[:, :, :P])
    assert bool((idx[keep] < P).all()) and bool((val[keep] != 0).all())
    steps = idx[:, :, 1:] - idx[:, :, :-1]
    assert bool((steps[keep[:, :, 1:]] > 0).all())                 # ascending columns
    assert torch.equal(count, (M[:, :, :P] != 0).sum(2, dtype=torch.int32))
    if CASES[case][3] == 'dense':
        assert bool((count == P).all())
    else:
        assert 0 < int(count.max()) <= 13                          # the kernel's band


@pytest.mark.parametrize('case', sorted(CASES))
def test_tap_lists_scatter_back_to_M(case):
    '''The backward's lists: each column's (l < P) nonzeros, rows
    ascending, counted, scattering back to exactly M[:, :, :P].'''
    _, _, _, M, _, _ = _inputs(case)
    M = torch.from_numpy(M)
    N = CASES[case][0]
    P, R = 2 * N - 2, M.shape[1]
    count, idx, val = agc.twopass_tap_lists_plain(M, P)
    assert count.dtype == idx.dtype == torch.int32 and val.dtype == torch.float32
    assert count.shape == (M.shape[0], P) and idx.shape == val.shape == (M.shape[0], P, R)
    back, keep = _scatter_back(count, idx, val, P, R)
    assert torch.equal(back.transpose(1, 2), M[:, :, :P])
    assert bool((idx[keep] < R).all()) and bool((val[keep] != 0).all())
    steps = idx[:, :, 1:] - idx[:, :, :-1]
    assert bool((steps[keep[:, :, 1:]] > 0).all())                 # ascending rows
    assert torch.equal(count, (M[:, :, :P] != 0).sum(1, dtype=torch.int32))
    if CASES[case][3] == 'dense':
        assert bool((count == R).all())


def _list_form(z, t, f, M, g):
    '''The list-form forward and backward of the port.'''
    N = z.shape[2]
    P = 2 * N - 2
    out = agc.linepass_fwd_lists_plain(z, t, f, agc.twopass_row_lists_plain(M, P))
    dz = agc.linepass_bwd_lists_plain(g, t, f, agc.twopass_tap_lists_plain(M, P), N)
    return out, dz


@pytest.mark.parametrize('case', sorted(CASES))
def test_fwd_lists_plain_matches_plain(case):
    z, t, f, M, _, g = _torch(*_inputs(case, seed=1))
    want = agc.linepass_fused_plain(z, t, f, M)
    got = _list_form(z, t, f, M, g)[0]
    assert got.shape == want.shape == (z.shape[0], z.shape[1], M.shape[1], z.shape[3])
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('case', sorted(CASES))
def test_bwd_lists_plain_matches_autograd(case):
    z, t, f, M, _, g = _torch(*_inputs(case, seed=2))
    zr = z.clone().requires_grad_(True)
    (want,) = torch.autograd.grad(agc.linepass_fused_plain(zr, t, f, M), zr, g)
    got = _list_form(z, t, f, M, g)[1]
    assert got.shape == want.shape == z.shape
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('case', sorted(CASES))
def test_fwd_lists_plain_matches_pallas_interpret(case):
    '''At 2e-6 against the Pallas kernel in interpret mode, which gets M
    cut to its P columns (it pads them itself).'''
    z, t, f, M, jM, g = _inputs(case, seed=3)
    want = jax.jit(lambda v: _jax_line(v, t, f, jM, M.shape[1]))(jnp.asarray(z))
    got = _list_form(*_torch(z, t, f, M, g))[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize('case', sorted(CASES))
def test_bwd_lists_plain_matches_pallas_interpret(case):
    '''At 2e-5 against `jax.grad` of the Pallas kernel in interpret mode.'''
    z, t, f, M, jM, g = _inputs(case, seed=3)
    want = jax.jit(jax.grad(lambda v: jnp.sum(_jax_line(v, t, f, jM, M.shape[1]) * g)))(
        jnp.asarray(z))
    got = _list_form(*_torch(z, t, f, M, g))[1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
