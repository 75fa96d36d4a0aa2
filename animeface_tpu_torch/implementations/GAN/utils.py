'''The vanilla GAN recipe in PyTorch: its training step and CLI.

Counterpart of `animeface_tpu/implementations/GAN/utils.py`: DCGAN's step
(`DCGAN/utils.py:build_train_step`) around the MLP models, which is the
JAX step: D's update on the reals and the detached fakes, then G's against
the updated D; G's BatchNorm updates kept from the D phase's forward and
dropped from the G phase's (D has none). The GAN loss, Adam (lr 1e-3,
betas (0.9, 0.999)) for both; samples and `G_<step>.pt` from G in eval
mode on 16 fixed latents. The recipe's flag is spelt `--latent-dim`.
'''

from __future__ import annotations

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.DCGAN import utils as dcgan
from animeface_tpu_torch.implementations.GAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import GANLoss
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (with the global ones: image 128, batch 32)
GAN_ARGS = {'latent-dim': [100, 'input latent dim']}


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('GAN', GAN_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G and D for `args.image_size` RGB images on `device` (default
    `cuda`), weights drawn from `seed`, computing in bf16 unless
    `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    shape = (3, args.image_size, args.image_size)
    dtype = dcgan.compute_dtype(args)
    G = Generator(latent_dim=args.latent_dim, image_shape=shape, dtype=dtype, generator=g)
    D = Discriminator(image_shape=shape, dtype=dtype, generator=g)
    return G.to(device), D.to(device)


def build_training(args, device=None, seed=0):
    '''Everything one GAN training step needs, from `seed` (the namespace
    of `DCGAN/utils.py:assemble_training`).'''
    G, D = build_models(args, device, seed)
    g_opt, d_opt = dcgan.make_optimizers(args, G, D)
    step = dcgan.build_train_step(G, D, g_opt, d_opt, GANLoss())
    return dcgan.assemble_training(G, D, g_opt, d_opt, {'step': step}, lambda i: 'step', seed)


def train(args, max_iters, loader, name='GAN'):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return dcgan.run_recipe(run, args, accel, max_iters, loader, name)


def main(parser):
    parser = add_args(parser, GAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader)
