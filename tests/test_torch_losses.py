'''The adversarial losses of the port against `animeface_tpu/nnutils/loss/gan.py`:
D's loss (with its two terms) and G's, on the same seeded logits, f32, to
1e-6 of their scale.'''

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from animeface_tpu.nnutils.loss import gan as jgan
from animeface_tpu_torch.nnutils.loss import gan as tgan


@pytest.mark.parametrize('name', ['GANLoss', 'LSGANLoss', 'NonSaturatingLoss', 'WGANLoss',
                                  'HingeLoss'])
def test_loss_matches_jax(name):
    rng = np.random.default_rng(0)
    real, fake = (rng.standard_normal((8, 25)).astype(np.float32) * 2 for _ in range(2))
    jl, tl = getattr(jgan, name)(return_all=True), getattr(tgan, name)(return_all=True)
    want = jl.d_loss(jnp.asarray(real), jnp.asarray(fake)) + (jl.g_loss(jnp.asarray(fake)),)
    got = tl.d_loss(torch.from_numpy(real), torch.from_numpy(fake)) + (
        tl.g_loss(torch.from_numpy(fake)),)
    for what, g, w in zip(('d', 'd real', 'd fake', 'g'), got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-7, err_msg=what)
    assert float(getattr(tgan, name)().d_loss(torch.from_numpy(real),
                                              torch.from_numpy(fake))) == float(got[0])
