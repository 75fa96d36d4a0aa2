'''SEBigGAN's models in PyTorch: BigGAN's unconditional G and D stacks with
squeeze-and-excitation gating ('se') as the attention.

Counterpart of `animeface_tpu/implementations/SEBigGAN/model.py`: the two
factory functions with the reference's argument order, every knob passed
through to BigGAN's `Generator`/`Discriminator` (attention once, at the
arch table's resolution, as in BigGAN).
'''

from __future__ import annotations

import torch

from animeface_tpu_torch.implementations.BigGAN.model import (
    Discriminator as _BigGANDiscriminator,
    Generator as _BigGANGenerator,
    SqueezeExcitation,
)

__all__ = ['Generator', 'Discriminator', 'SqueezeExcitation']


def Generator(image_size: int = 128, z_dim: int = 120, deep: bool = False,
              channels: int = 64, use_sn: bool = True, att_name: str = 'se',
              act_name: str = 'relu', norm_name: str = 'bn', dtype=torch.float32,
              generator=None):
    return _BigGANGenerator(
        image_size=image_size, z_dim=z_dim, channels=channels, deep=deep,
        use_sn=use_sn, att_name=att_name, norm_name=norm_name,
        act_name=act_name, dtype=dtype, generator=generator)


def Discriminator(image_size: int = 128, deep: bool = False,
                  channels: int = 64, use_sn: bool = True,
                  att_name: str = 'se', act_name: str = 'relu', dtype=torch.float32,
                  generator=None):
    return _BigGANDiscriminator(
        image_size=image_size, channels=channels, deep=deep, use_sn=use_sn,
        att_name=att_name, act_name=act_name, dtype=dtype, generator=generator)
