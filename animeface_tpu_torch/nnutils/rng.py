'''Random draws from an explicit `torch.Generator`.

Counterpart of `animeface_tpu/nnutils/rng.py`. JAX threads PRNG keys; here
the caller creates and seeds a generator on the device it draws for and
passes it. The two frameworks give different numbers from one seed, so
tests make their draws with numpy and hand them to both.
'''

from __future__ import annotations

import torch


def make_generator(seed: int, device) -> torch.Generator:
    '''A generator on `device`, seeded with `seed`.'''
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    return g


def sample_nnoise(size, generator: torch.Generator, mean: float = 0., std: float = 1.,
                  dtype=torch.float32):
    '''Normal noise on the generator's device.'''
    return torch.randn(size, generator=generator, dtype=dtype,
                       device=generator.device) * std + mean
