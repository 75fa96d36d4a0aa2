'''Port ops (animeface_tpu_torch.ops) against the JAX package's 'xla' ops.

Same seeded numpy inputs on both sides; NHWC on the JAX side, NCHW in the
port. f32 on the CPU: the two sides sum the same taps in another order, so
the tolerance is 1e-5 abs on unit-scale inputs.
'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from animeface_tpu import ops as jops
from animeface_tpu_torch import ops as tops

TOL = 1e-5


def _pair(shape=(2, 9, 11, 3), seed=0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.transpose(0, 3, 1, 2).copy())


def _close(jout, tout):
    np.testing.assert_allclose(tout.numpy().transpose(0, 2, 3, 1),
                               np.asarray(jout), atol=TOL, rtol=0)


FILTERS = {
    '2d': np.outer([1., 3., 3., 1.], [1., 2., 1., 0.5]).astype(np.float32),
    'sep': np.asarray([0.1, -0.3, 0.7, 1.0, 0.4, -0.2, 0.05, 0.3], np.float32),
}


@pytest.mark.parametrize('fname', sorted(FILTERS))
@pytest.mark.parametrize('up,down,padding,flip,gain', [
    (1, 1, 0, False, 1.0),
    (2, 1, [2, 1, 3, 1], False, 4.0),
    (1, 2, [1, 2, 0, 1], True, 1.0),
    ((2, 1), (1, 2), [3, 0, 1, 2], False, 2.0),
    (2, 2, [-1, 2, 2, -1], True, 0.5),          # crop on one side
])
def test_upfirdn2d_matches_jax(fname, up, down, padding, flip, gain):
    jx, tx = _pair()
    f = FILTERS[fname]
    jf = jops.setup_filter(f, normalize=False, separable=fname == 'sep')
    tf = tops.setup_filter(f, normalize=False, separable=fname == 'sep')
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), atol=0)
    _close(jops.upfirdn2d(jx, jf, up, down, padding, flip, gain),
           tops.upfirdn2d(tx, tf, up, down, padding, flip, gain))


@pytest.mark.parametrize('taps', [[1, 2, 1], [1, 3, 3, 1], FILTERS['sep'].tolist()])
@pytest.mark.parametrize('op', ['filter2d', 'upsample2d', 'downsample2d'])
def test_resample_ops_match_jax(op, taps):
    jx, tx = _pair(seed=1)
    jf, tf = jops.setup_filter(taps), tops.setup_filter(taps)
    kw = {} if op == 'filter2d' else {'padding': 1}
    _close(getattr(jops, op)(jx, jf, **kw), getattr(tops, op)(tx, tf, **kw))


def test_setup_filter_gain_and_flip():
    f = [1., 2., 4.]
    for kw in (dict(flip_filter=True, gain=4.0), dict(normalize=False, gain=2.0),
               dict(separable=True, gain=9.0)):
        np.testing.assert_allclose(tops.setup_filter(f, **kw).numpy(),
                                   np.asarray(jops.setup_filter(f, **kw)), atol=1e-7)
