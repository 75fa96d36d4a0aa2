'''The two-pass warp's backward in list form: the tap lists the CUDA chain
builds (`twopass_tap_lists_plain`) and the plain list-form backward
(`twopass_bwd_lists_plain`), against autograd through the plain two-pass
warp and against `jax.grad` of the JAX package's Pallas `twopass_fused` in
interpret mode.

Same seeded numpy inputs on both sides, f32 on the CPU, N = 16, We = 40 in
a 48-column canvas (the padding columns get a zero gradient), C = 3.
Tolerances, of max(1, the gradient's scale): 1e-5 against autograd (the
same taps and blends, summed in another order) and 2e-4 against JAX (the
JAX package's own fused-vs-dense gradient tolerance,
tests/test_ada_twopass.py, also used by tests/test_torch_ada.py).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.nnutils import ada_geometry as jgeo
from animeface_tpu.nnutils.ada_geometry_tpu import twopass_fused as j_twopass_fused
from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

B, C, N, WE, WEP = 2, 3, 16, 40, 48
P1, P2 = 2 * N - 2, 2 * WE - 2

#: M from `_pass_params` at fixed slopes (pass 1, pass 2), or random taps
#: (banded around a line of slope 0.7-1.4, or dense)
CASES = {
    'banded': dict(band=6.5),
    'dense': dict(band=None),
    'slope_0.05': dict(slopes=(0.05, 0.05)),       # columns full to the row count
    'slope_3-4': dict(slopes=(3.5, 3.2)),          # M2: a few taps a column, and empty ones
    'wrap': dict(slopes=(1.1, 0.9), wrap=True),    # bands across the cyclic period
}


def _random_matrix(rng, rows, P, band):
    M = rng.standard_normal((B, rows, P)).astype(np.float32) / 4
    if band is not None:
        q = (rng.uniform(0.7, 1.4, (B, 1, 1)) * np.arange(rows)[None, :, None]
             + rng.uniform(-P, P, (B, 1, 1)))
        d = np.mod(q - np.arange(P)[None, None, :] + P / 2, P) - P / 2
        M = np.where(np.abs(d) < band, M, 0.0).astype(np.float32)
    return M


def _inputs(case, seed=0):
    '''x [B, C, N, WEP], the pass parameters and g [B, C, N, N], as numpy
    arrays; M padded with zero columns to a multiple of 8.'''
    rng = np.random.default_rng(seed)
    spec = CASES[case]
    if 'slopes' in spec:
        half, support = jgeo.derive_axis_kernel()
        cols = np.arange(WEP, dtype=np.float32) - (WEP - 1) / 2
        rows = np.arange(N, dtype=np.float32) - (N - 1) / 2
        params = []
        for slope, lines, P in zip(spec['slopes'], (cols, rows), (P1, P2)):
            base = rng.uniform(P - N, P, B) if spec.get('wrap') else rng.uniform(-3, 3, B)
            params.append([np.asarray(a) for a in jgeo._pass_params(
                jnp.full((B,), slope, jnp.float32),
                jnp.asarray(rng.uniform(-0.6, 0.6, B), jnp.float32),
                jnp.asarray(base, jnp.float32), lines, N, P, half, support)])
        (t1, f1, M1), (t2, f2, M2) = params
    else:
        t1 = rng.integers(0, P1, (B, WEP)).astype(np.int32)
        f1 = rng.uniform(0, 1, (B, WEP)).astype(np.float32)
        t2 = rng.integers(0, P2, (B, N)).astype(np.int32)
        f2 = rng.uniform(0, 1, (B, N)).astype(np.float32)
        M1 = _random_matrix(rng, N, P1, spec['band'])
        M2 = _random_matrix(rng, N, P2, spec['band'])
    M1 = np.pad(M1, ((0, 0), (0, 0), (0, -(-P1 // 8) * 8 - P1)))
    M2 = np.pad(M2, ((0, 0), (0, 0), (0, -(-P2 // 8) * 8 - P2)))
    x = rng.standard_normal((B, C, N, WEP)).astype(np.float32)
    g = rng.standard_normal((B, C, N, N)).astype(np.float32)
    return [x, t1, f1, M1, t2, f2, M2], g


def _torch(arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _list_form_dx(arrays, g):
    x, t1, f1, M1, t2, f2, M2 = _torch(arrays)
    lists1 = agc.twopass_tap_lists_plain(M1, P1)
    lists2 = agc.twopass_tap_lists_plain(M2, P2)
    return agc.twopass_bwd_lists_plain(torch.from_numpy(g), t1, f1, t2, f2, lists1, lists2,
                                       P1, P2, WE)


@pytest.mark.parametrize('case', sorted(CASES))
def test_tap_lists_scatter_back_to_M(case):
    '''Each list set scatters back to exactly M[:, :, :P], its rows ascend
    and its counts are the columns' nonzeros; the cases reach both extremes
    of the column counts.'''
    arrays, _ = _inputs(case)
    for M, P in ((arrays[3], P1), (arrays[6], P2)):
        M = torch.from_numpy(np.array(M))
        count, idx, val = agc.twopass_tap_lists_plain(M, P)
        R = M.shape[1]
        assert count.dtype == idx.dtype == torch.int32 and val.dtype == torch.float32
        assert count.shape == (B, P) and idx.shape == val.shape == (B, P, R)
        keep = torch.arange(R) < count[..., None]
        back = torch.zeros((B, P, R))
        back.scatter_add_(2, idx.long(), torch.where(keep, val, 0.0))
        assert torch.equal(back.transpose(1, 2), M[:, :, :P])
        assert bool((idx[keep] < R).all()) and bool((val[keep] != 0).all())
        steps = idx[:, :, 1:] - idx[:, :, :-1]
        assert bool((steps[keep[:, :, 1:]] > 0).all())              # ascending rows
        assert torch.equal(count, (M[:, :, :P] != 0).sum(1, dtype=torch.int32))
        if case == 'slope_0.05':
            assert int(count.max()) == R                           # a full column
        if case == 'slope_3-4':
            assert P == P1 or (int(count.max()) <= 5 and int((count == 0).sum()) > 0)
        if case == 'dense':
            assert bool((count == R).all())


@pytest.mark.parametrize('case', sorted(CASES))
def test_bwd_lists_plain_matches_autograd(case):
    arrays, g = _inputs(case, seed=1)
    x, *rest = _torch(arrays)
    x.requires_grad_(True)
    out = agc.twopass_fused_plain(x, *rest, P1, P2, WE, N)
    (want,) = torch.autograd.grad(out, x, torch.from_numpy(g))
    got = _list_form_dx(arrays, g)
    assert got.shape == want.shape == (B, C, N, WEP)
    assert float(got[..., WE:].abs().max()) == 0.0
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('case', sorted(CASES))
def test_bwd_lists_plain_matches_pallas_interpret(case):
    arrays, g = _inputs(case, seed=2)
    jarrays = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jax.jit(jax.grad(lambda x: jnp.sum(
        j_twopass_fused(x, *jarrays[1:], P1, P2, WE, N, True) * g)))(jarrays[0]))
    got = _list_form_dx(arrays, g).numpy()
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-4 * scale, rtol=0)
