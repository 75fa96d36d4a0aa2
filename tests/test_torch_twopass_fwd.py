'''The two-pass warp's forward in list form: the row lists the CUDA forward
builds (`twopass_row_lists_plain`) and the plain list-form forward
(`twopass_fwd_lists_plain`), against the plain two-pass warp and against
the JAX package's Pallas `twopass_fused` in interpret mode.

The inputs and cases are the backward's (`test_torch_twopass_bwd.py`):
seeded numpy, f32 on the CPU, N = 16, We = 40 in a 48-column canvas,
C = 3. Tolerances, of max(1, the output's scale): 1e-5 against the plain
warp (the same taps and blends, summed in another order) and 2e-5 against
JAX (the forward tolerance of tests/test_torch_ada.py).
'''

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from animeface_tpu.nnutils.ada_geometry_tpu import twopass_fused as j_twopass_fused
from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc
from test_torch_twopass_bwd import B, C, CASES, N, P1, P2, WE, _inputs, _torch


def _list_form_out(arrays):
    x, t1, f1, M1, t2, f2, M2 = _torch(arrays)
    rows1 = agc.twopass_row_lists_plain(M1, P1)
    rows2 = agc.twopass_row_lists_plain(M2, P2)
    return agc.twopass_fwd_lists_plain(x, t1, f1, t2, f2, rows1, rows2, P1, P2, WE, N)


@pytest.mark.parametrize('case', sorted(CASES))
def test_row_lists_scatter_back_to_M(case):
    '''Each list set scatters back to exactly M[:, :, :P], its columns
    ascend and its counts are the rows' nonzeros; dense M fills every row
    to P.'''
    arrays, _ = _inputs(case)
    for M, P in ((arrays[3], P1), (arrays[6], P2)):
        M = torch.from_numpy(np.array(M))
        count, idx, val = agc.twopass_row_lists_plain(M, P)
        R = M.shape[1]
        assert count.dtype == idx.dtype == torch.int32 and val.dtype == torch.float32
        assert count.shape == (B, R) and idx.shape == val.shape == (B, R, P)
        keep = torch.arange(P) < count[..., None]
        back = torch.zeros((B, R, P))
        back.scatter_add_(2, idx.long(), torch.where(keep, val, 0.0))
        assert torch.equal(back, M[:, :, :P])
        assert bool((idx[keep] < P).all()) and bool((val[keep] != 0).all())
        steps = idx[:, :, 1:] - idx[:, :, :-1]
        assert bool((steps[keep[:, :, 1:]] > 0).all())              # ascending columns
        assert torch.equal(count, (M[:, :, :P] != 0).sum(2, dtype=torch.int32))
        if case == 'dense':
            assert bool((count == P).all())


@pytest.mark.parametrize('case', sorted(CASES))
def test_fwd_lists_plain_matches_plain_warp(case):
    arrays, _ = _inputs(case, seed=1)
    want = agc.twopass_fused_plain(*_torch(arrays), P1, P2, WE, N)
    got = _list_form_out(arrays)
    assert got.shape == want.shape == (B, C, N, N)
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize('case', sorted(CASES))
def test_fwd_lists_plain_matches_pallas_interpret(case):
    arrays, _ = _inputs(case, seed=2)
    jarrays = [jnp.asarray(a) for a in arrays]
    want = np.asarray(jax.jit(lambda *a: j_twopass_fused(*a, P1, P2, WE, N, True))(*jarrays))
    got = _list_form_out(arrays).numpy()
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=2e-5 * scale, rtol=0)
