'''The fused filtered_lrelu kernel's polyphase order on the CPU:
`filtered_lrelu_taps` (the taps the templated kernel takes by value) and
`filtered_lrelu_phases_plain` (its four separable stages with no zero
insertion, in the kernel's order) against the composition
`filtered_lrelu_plain` (1e-5 of the output's scale: the same f32 sums in
another order) and against the JAX package's `filtered_lrelu_pallas` in
interpret mode (2e-6 abs on unit-scale inputs, as
`tests/test_torch_kernels_ops.py` holds the composition).

The cases run each size class (12 and 24 taps, and 12 up with 8 down),
px0 and py0 each even and odd, asymmetric padding, non-square maps and
the clamp on and off: the phase and padding bookkeeping the kernel relies
on, checked before any card sees it.
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from animeface_tpu.ops import pallas_kernels as jpk
from animeface_tpu.ops.upfirdn2d import setup_filter as jsetup_filter
from animeface_tpu_torch.ops import cuda_kernels as ck

SQRT2 = float(np.sqrt(2))

# (taps up, taps down, padding (px0, px1, py0, py1), H, W, clamp, bias); every
# case keeps out_w == W as well as out_h == H: the Pallas kernel's scope checks
# only out_h, and in interpret mode it leaves NaN where out_w != W
CASES = [
    (12, 12, (11, 11, 11, 11), 16, 24, None, True),   # the path's padding, odd / odd
    (12, 12, (10, 11, 11, 11), 16, 24, 0.5, True),    # even px0
    (12, 12, (11, 11, 10, 12), 16, 16, None, True),   # even py0
    (12, 12, (10, 12, 10, 11), 16, 16, 0.8, False),   # both even
    (12, 8, (9, 8, 10, 8), 16, 24, 0.8, True),        # Ld < K; odd px0, even py0
    (12, 8, (8, 9, 9, 9), 16, 24, None, True),        # even px0, odd py0
    (24, 24, (23, 22, 23, 22), 16, 24, None, True),   # the 24-tap class, odd / odd
    (24, 24, (22, 23, 22, 23), 16, 16, 0.8, True),    # both even
]
IDS = [f'{c[0]}x{c[1]}_pad{"_".join(map(str, c[2]))}' for c in CASES]


def _inputs(Lu, Ld, padding, H, W, clamp, bias, C=128):
    '''Seeded NHWC x, filters (the Hann filter at 12 taps, asymmetric
    otherwise) and bias, as numpy f32.'''
    rng = np.random.default_rng(Lu * 100 + Ld + sum(padding))
    hann = np.array(jsetup_filter(np.hanning(12), normalize=True))
    fu, fd = (hann if L == 12 and Lu == Ld else rng.uniform(0.1, 1.0, L).astype(np.float32)
              for L in (Lu, Ld))
    fu, fd = fu / fu.sum(), fd / fd.sum()
    x = rng.standard_normal((2, H, W, C)).astype(np.float32)
    b = (rng.standard_normal(C) * 0.3).astype(np.float32) if bias else None
    return x, fu.astype(np.float32), fd.astype(np.float32), b


def _phases(x, fu, fd, b, padding, clamp):
    out = ck.filtered_lrelu_phases_plain(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), torch.from_numpy(fu),
        torch.from_numpy(fd), None if b is None else torch.from_numpy(b), padding, SQRT2, 0.2,
        clamp)
    return out.numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize('Lu,Ld,padding,H,W,clamp,bias', CASES, ids=IDS)
def test_phases_plain_matches_plain(Lu, Ld, padding, H, W, clamp, bias):
    x, fu, fd, b = _inputs(Lu, Ld, padding, H, W, clamp, bias)
    want = ck.filtered_lrelu_plain(
        torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))), torch.from_numpy(fu),
        torch.from_numpy(fd), None if b is None else torch.from_numpy(b), padding, SQRT2, 0.2,
        clamp).numpy().transpose(0, 2, 3, 1)
    got = _phases(x, fu, fd, b, padding, clamp)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize('Lu,Ld,padding,H,W,clamp,bias', CASES, ids=IDS)
def test_phases_plain_matches_pallas(Lu, Ld, padding, H, W, clamp, bias):
    x, fu, fd, b = _inputs(Lu, Ld, padding, H, W, clamp, bias)
    want = jpk.filtered_lrelu_pallas(jnp.asarray(x), fu, fd, None if b is None else jnp.asarray(b),
                                     2, 2, padding, SQRT2, 0.2, clamp, False)
    assert want is not None, 'out of the Pallas kernel\'s scope'
    np.testing.assert_allclose(_phases(x, fu, fd, b, padding, clamp), np.asarray(want),
                               atol=2e-6, rtol=0)


@pytest.mark.parametrize('Lu,Ld,K', [(12, 12, 12), (12, 8, 12), (7, 12, 12), (13, 4, 24),
                                     (24, 24, 24), (25, 12, None), (12, 30, None)])
def test_size_class(Lu, Ld, K):
    assert ck.filtered_lrelu_size_class(Lu, Ld) == K


@pytest.mark.parametrize('px0,py0', [(11, 11), (10, 11), (11, 10), (10, 10)])
def test_taps_layout(px0, py0):
    '''`Taps<K>`: up_h[r][j] = gu[(py0 - r) % 2 + 2 j], up_w likewise with
    px0, then gd; gu = flip(fu) * 2 and gd = flip(fd), zero past their
    lengths.'''
    rng = np.random.default_rng(px0 * 10 + py0)
    fu, fd = rng.uniform(size=11).astype(np.float32), rng.uniform(size=8).astype(np.float32)
    K = 12
    taps = ck.filtered_lrelu_taps(torch.from_numpy(fu), torch.from_numpy(fd), px0, py0, K)
    assert taps.dtype == torch.float32 and taps.shape == (3 * K,)
    gu = np.zeros(K + 1, np.float32)
    gu[:11] = fu[::-1] * 2
    gd = np.zeros(K, np.float32)
    gd[:8] = fd[::-1]
    want = [gu[(p0 - r) % 2::2][:K // 2] for p0 in (py0, px0) for r in (0, 1)] + [gd]
    np.testing.assert_array_equal(taps.numpy(), np.concatenate(want))
