'''The VAN GAN recipe in PyTorch: its models, optimizers and CLI on the
simple-GAN trunk (`nnutils/simple_gan.py`).

Counterpart of `animeface_tpu/implementations/VAN/utils.py`: the `add_args`
schema (names, defaults, help); the non-saturating loss with R1
(`gp_lambda`) every step; no DiffAugment; Adam (lr, betas, eps 1e-8), with
`--ttur` G at lr / 2 and D at lr * 2; N(0, 0.02) redrawn over the kernels
(`init_func` 'N002'); the EMA of G sampled; no cuDNN autotuning. The step,
the optimizers and those constants are ConvNeXt's (`ConvNeXt/utils.py`).
'''

from __future__ import annotations

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.ConvNeXt.utils import (  # noqa: F401 (build_step)
    AUTOTUNE, GP_EVERY, INIT_FUNC, POLICY, build_step, compute_dtype, make_optimizers)
from animeface_tpu_torch.implementations.VAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import simple_gan
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `VAN/utils.py:main`, names, defaults and help)
VAN_ARGS = dict(
    num_test=[16, 'number of samples for eval'],
    image_channels=[3, 'image channels'],
    latent_dim=[128, 'input latent dimension'],
    bottom=[4, 'bottom width'],
    channels=[64, 'channel width'],
    max_channels=[int, 'maximum channel width'],
    blocks_per_scale=[2, 'number of blocks per scale'],
    norm_name=['ln', 'normalization layer name'],
    act_name=['gelu', 'activation function name'],
    layers=[[3, 3, 9, 3], 'layers'],
    lr=[0.0001, 'learning rate'],
    betas=[[0.5, 0.99], 'betas'],
    ttur=[False, 'use TTUR'],
    gp_lambda=[10., 'lambda for gradient penalty'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('VAN', VAN_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G, D and G_ema on `device` (default `cuda`), weights drawn from
    `seed` and redrawn N(0, 0.02), computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = compute_dtype(args)
    G = Generator(latent_dim=args.latent_dim, image_size=args.image_size, bottom=args.bottom,
                  channels=args.channels, max_channels=args.max_channels,
                  blocks_per_scale=args.blocks_per_scale, out_channels=args.image_channels,
                  norm_name=args.norm_name, act_name=args.act_name, dtype=dtype, generator=g)
    D = Discriminator(layers=tuple(args.layers), channels=args.channels,
                      max_channels=args.max_channels, in_channels=args.image_channels,
                      norm_name=args.norm_name, act_name=args.act_name, dtype=dtype, generator=g)
    G, D = simple_gan.init_models(G, D, INIT_FUNC, seed)
    G, D = G.to(device), D.to(device)
    return G, D, simple_gan.ema_copy(G, True)


def build_training(args, device=None, seed=0):
    '''Everything one VAN training step needs, from `seed`
    (`simple_gan.build_training`).'''
    G, D, G_ema = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    return simple_gan.build_training(G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), POLICY,
                                     args.gp_lambda, GP_EVERY, num_test=args.num_test, seed=seed)


def main(parser):
    parser = add_args(parser, VAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    run = build_training(args, accel.device, seed=args.seed)
    simple_gan.run_simple_gan('VAN', run, args, accel, loader, max_iters)
