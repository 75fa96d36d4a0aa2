'''One step of the simple-GAN trunk of the port against JAX's for ConvNeXt
and VAN, the plain and the R1 variant (the recipes run R1 every step), as
`tests/test_torch_simple_gan_steps.py` holds TransGAN and HiT: one bridged
state, the JAX step's draws, plain SGD on both sides, losses, parameters
and G_ema at 1e-4 of their scale, gradients against the port's float64
step at 1e-4 of their scale (floored at 1e-2 of the model's largest) plus
the float32 step's own distance from it.
'''

import pytest

from test_torch_pggan import one_thread  # noqa: F401  (autouse fixture)
from test_torch_simple_gan_steps import check_step, make_recipe


@pytest.fixture(scope='module', params=['ConvNeXt', 'VAN'])
def recipe(request):
    return make_recipe(request.param)


@pytest.mark.parametrize('do_r1', [False, True], ids=['plain', 'r1'])
def test_step_matches_jax(recipe, do_r1):
    check_step(recipe, do_r1)
