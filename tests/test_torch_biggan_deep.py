'''BigGAN-deep's G and D in the port against `animeface_tpu/implementations/
BigGAN/model.py`, with the helpers of `tests/test_torch_biggan_nets.py`:
the converters and forwards in train and eval mode with 'sa' attention
and relu, and with 'se' attention and prelu (one slope per module), every
u and running statistic they leave. 32px, channels 4, z 16, batch 4, f32
on the CPU, one intra-op thread; tolerance 1e-4 of the output's scale.
'''

import pytest

from test_torch_biggan_nets import NETS, check_converters, check_forward
from test_torch_pggan import one_thread  # noqa: F401  (autouse fixture)

DEEP = [n for n in NETS if NETS[n][0]]


@pytest.mark.parametrize('name', DEEP)
def test_converters_cover_every_entry(name):
    check_converters(name, 3, 2, 7)


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
@pytest.mark.parametrize('name', DEEP)
def test_generator_and_discriminator_match_jax(name, train):
    check_forward(name, train)
