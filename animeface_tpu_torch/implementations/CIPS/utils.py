'''The CIPS recipe in PyTorch: its defaults, its models, its training step
and its sampler.

Counterpart of `animeface_tpu/implementations/CIPS/utils.py`: the CLI
defaults of `main`, the models `train` builds (G in the compute dtype,
bf16 unless `no_bf16`, StyleGAN3's D, the EMA copy of G), the step and
`sample_fn`, the G_ema forward on `num_test` fixed latents. The JAX step
is StyleGAN3's with DiffAugment, line for line: the non-saturating loss
with additive R1 (times gp_lambda, on the raw reals) where step %
gp_every == 0, DiffAugment with the reals' draws and the fakes' (again in
the G phase), the G phase on the pre-step `w_avg` while the step keeps the
D-phase forward's, the mapping at lr * map_lr_scale (the top-level
`Linear_*` of the JAX G, the port's `map.*`), Adam (0, 0.99), G EMA 0.999
with the moments copied. So the port's step, optimizers and state are
StyleGAN3's (`build_train_step`, `make_optimizers`, `init_state`), and
`build_training` assembles them around CIPS's models. Training runs the
ops registry's default ('torch'; the 'cuda' kernels are forward only), the
sampler impl 'cuda'.
'''

from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.CIPS.model import Discriminator, Generator
from animeface_tpu_torch.implementations.StyleGAN3 import utils as sg3
from animeface_tpu_torch.implementations.StyleGAN3.utils import (  # noqa: F401
    build_train_step, init_state, make_optimizers)
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.ops import registry

#: the recipe's CLI defaults (`main`), and the global ones it runs with
#: (`utils/argument.py`: image 128, batch 32)
CIPS_DEFAULTS = dict(
    image_size=128, batch_size=32, num_test=16, image_channels=3, latent_dim=512,
    style_dim=512, num_layers=14, g_channels=32, g_max_channels=512, map_num_layers=4,
    no_pixel_norm=False, d_channels=64, d_max_channels=512, mbsd_group_size=4,
    mbsd_channels=1, bottom=4, filter_size=4, lr=0.0025, map_lr_scale=0.01,
    betas=(0., 0.99), gp_lambda=10., gp_every=16, policy='color,translation', no_bf16=False)


def default_args(**overrides):
    '''The recipe's defaults as an argument namespace, with overrides.'''
    unknown = set(overrides) - set(CIPS_DEFAULTS)
    if unknown:
        raise TypeError(f'unknown CIPS arguments: {sorted(unknown)}')
    return SimpleNamespace(**dict(CIPS_DEFAULTS, **overrides))


def build_models(args, device=None, seed=0):
    '''G, D and the EMA copy of G on `device` (default `cuda`), weights
    drawn from `seed`, computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    compute_dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    g = torch.Generator().manual_seed(int(seed))
    G = Generator(
        image_size=args.image_size, latent_dim=args.latent_dim, style_dim=args.style_dim,
        num_layers=args.num_layers, channels=args.g_channels, max_channels=args.g_max_channels,
        image_channels=args.image_channels, map_num_layers=args.map_num_layers,
        pixel_norm=not args.no_pixel_norm, dtype=compute_dtype, generator=g)
    D = Discriminator(
        image_size=args.image_size, in_channels=args.image_channels, channels=args.d_channels,
        max_channels=args.d_max_channels, mbsd_group_size=args.mbsd_group_size,
        mbsd_channels=args.mbsd_channels, bottom=args.bottom, filter_size=args.filter_size,
        dtype=compute_dtype, generator=g)
    G, D = G.to(device), D.to(device)
    G_ema = copy.deepcopy(G).requires_grad_(False)
    return G, D, G_ema


def make_sampler(G_ema, args, seed=0, impl=None):
    '''The recipe's `sample_fn`: `sample()` runs G_ema (train=False, under
    torch.no_grad()) on `num_test` latents drawn once from `seed` on
    G_ema's device, with the ops registry's default set to `impl` for the
    call (None keeps it).'''
    device = next(G_ema.parameters()).device
    const_z = sample_nnoise((args.num_test, args.latent_dim), make_generator(seed, device))

    def sample():
        before = registry.get_default_impl()
        registry.set_default_impl(before if impl is None else impl)
        try:
            with torch.no_grad():
                return G_ema(const_z)
        finally:
            registry.set_default_impl(before)

    return sample


def build_training(args, device=None, seed=0):
    '''Everything one CIPS training step needs, from `seed`: StyleGAN3's
    `assemble_training` namespace around CIPS's models (G, D, G_ema, the
    optimizers, `state`, `steps[do_r1]`, `uses_r1`, `train_step(state,
    real, draws=None) -> metrics`), and `sample_fn`, the sampler on G_ema
    under impl 'cuda'.'''
    G, D, G_ema = build_models(args, device, seed)
    run = sg3.assemble_training(args, G, D, G_ema, seed)
    run.sample_fn = make_sampler(G_ema, args, seed, impl='cuda')
    return run
