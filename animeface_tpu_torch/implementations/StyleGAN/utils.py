'''The StyleGAN (v1) recipe in PyTorch: PGGAN's phase machine, step and
progressive loop with the non-saturating loss and StyleGAN's schedule.

Counterpart of `animeface_tpu/implementations/StyleGAN/utils.py`, which
copies PGGAN's loop; here the two recipes share
`PGGAN/utils.py:train`. Differences from PGGAN: `resl2num` {4: 2, 8: 2,
16: 3, 32: 4, 64: 4, 128: 4}; the loss `NonSaturatingLoss`;
drift_epsilon 1e-4; latent_dim 512, also G's style width; the draws add
G's noise maps, the same maps for both G calls of a step (JAX passes one
noise key to both), and the snapshots and `final.png` use one fixed set.
Results go to `StyleGAN/result/`, with PGGAN's artifacts and sidecars.
'''

from __future__ import annotations

from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.PGGAN import utils as pggan
from animeface_tpu_torch.implementations.StyleGAN.model import (
    Discriminator, Generator, RESOLUTIONS, noise_shapes)
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from animeface_tpu_torch.nnutils.rng import sample_nnoise
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

resl2num = {4: 2, 8: 2, 16: 3, 32: 4, 64: 4, 128: 4}

#: the recipe's flags (with the global ones, as PGGAN's)
STYLEGAN_ARGS = dict(
    latent_dim=[512, 'latent input dimension'],
    gp_lambda=[10., 'lambda for gradient penalty'],
    drift_epsilon=[0.0001, 'epsilon for drift'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('StyleGAN', STYLEGAN_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G (style width = latent_dim, as the JAX trainer passes it) and D
    with every block up to `args.image_size` on `device` (default `cuda`),
    weights drawn from `seed`, computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    max_depth = RESOLUTIONS.index(args.image_size)
    dtype = pggan.compute_dtype(args)
    G = Generator(args.latent_dim, args.latent_dim, max_depth, dtype=dtype, generator=g)
    D = Discriminator(max_depth, dtype, g)
    return G.to(device), D.to(device)


def draw_step_inputs(G, real, generator, depth):
    '''PGGAN's draws (z, the penalty's alpha) and G's noise maps at `depth`.'''
    draws = pggan.draw_step_inputs(G, real, generator, depth)
    draws['noise'] = [sample_nnoise(s, generator) for s in noise_shapes(real.shape[0], depth)]
    return draws


def build_train_step(G, D, g_opt, d_opt, loss, gp_lambda, drift_epsilon, depth, g_mode, d_mode):
    '''PGGAN's step with these draws.'''
    return pggan.build_train_step(G, D, g_opt, d_opt, loss, gp_lambda, drift_epsilon, depth,
                                  g_mode, d_mode, draw_step_inputs)


RECIPE = SimpleNamespace(name='StyleGAN', build_models=build_models, loss=NonSaturatingLoss,
                         resl2num=resl2num, draw=draw_step_inputs, noise_shapes=noise_shapes)


def main(parser):
    parser = add_args(parser, STYLEGAN_ARGS)
    args = parser.parse_args()
    save_args(args)
    pggan.train(args, pggan.dataset_factory(args), RECIPE)
