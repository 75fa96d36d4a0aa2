'''The CIPS recipe in PyTorch: its defaults, its models, its training step
and its sampler.

Counterpart of `animeface_tpu/implementations/CIPS/utils.py`: the CLI
defaults of `main`, the models `train` builds (G in the compute dtype,
bf16 unless `no_bf16`, StyleGAN3's D, the EMA copy of G), the step and
`sample_fn`, the G_ema forward on `num_test` fixed latents, and `train`
and `main` (StyleGAN3's `run_recipe`: the R1 variant where i % gp_every
== 0 from the host step index, grids of G_ema with its moments, and
G_ema's state dict as `G_<step>.pt`). The JAX step
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
samplers (`sample_fn` and the CLI's grids) impl 'cuda'.
'''

from __future__ import annotations

import copy

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.CIPS.model import Discriminator, Generator
from animeface_tpu_torch.implementations.StyleGAN3 import utils as sg3
from animeface_tpu_torch.implementations.StyleGAN3.utils import (  # noqa: F401
    build_train_step, init_state, make_optimizers)
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.ops import registry
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (`main`; with the global ones: image 128, batch 32)
CIPS_ARGS = dict(
    num_test=[16, 'number of images for eval'],
    image_channels=[3, 'image channels'],
    latent_dim=[512, 'dimension of input latent'],
    style_dim=[512, 'dimension of style code'],
    num_layers=[14, 'number of style layers'],
    g_channels=[32, 'minimum channel width'],
    g_max_channels=[512, 'maximum channel width'],
    map_num_layers=[4, 'number of layers in mapping network'],
    no_pixel_norm=[False, 'disable pixel normalization'],
    d_channels=[64, 'minimum channel width'],
    d_max_channels=[512, 'maximum channel width'],
    mbsd_group_size=[4, 'mini-batch standard deviation group size'],
    mbsd_channels=[1, 'mini-batch standard deviation channels'],
    bottom=[4, 'bottom width'],
    filter_size=[4, 'filter size'],
    lr=[0.0025, 'learning rate'],
    map_lr_scale=[0.01, 'scale learning rate for mapping network with'],
    betas=[[0., 0.99], 'betas'],
    gp_lambda=[10., 'lambda for gradient penalty'],
    gp_every=[16, 'R1 every N steps'],
    policy=['color,translation', 'policy for diffaugment'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('CIPS', CIPS_ARGS, overrides)


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

    @torch.no_grad()
    def sample():
        with registry.default_impl(impl):
            return G_ema(const_z)

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


def train(args, max_iters, loader, name='CIPS'):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return sg3.run_recipe(run, args, accel, max_iters, loader, name, sample_impl='cuda')


def main(parser):
    parser = add_args(parser, CIPS_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader)
