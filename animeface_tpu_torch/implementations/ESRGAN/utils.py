'''The ESRGAN recipe in PyTorch: the RRDB G and SRGAN's multi-scale D on the
sr task, with the relativistic average loss and VGG16's content loss.

Counterpart of `animeface_tpu/implementations/ESRGAN/utils.py`: its flags
(`num_blocks` counts RRDBs; `g_norm_name` is accepted and unused, the
dense blocks have no norm) and SRGAN's step with `relativistic`
(`SRGAN/utils.py:build_train_step`): D on r - mean(f) and f - mean(r), G
on f - mean(r) from a second real forward of D, no gradient through r.
'''

from __future__ import annotations

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.ESRGAN.model import Generator
from animeface_tpu_torch.implementations.SRGAN import utils as srgan
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `ESRGAN/utils.py:main`, names, defaults and help)
ESRGAN_ARGS = dict(
    num_test=[6, 'number of test data'],
    scale=[2., 'upsample scale'],
    disable_sn=[False, 'disable spectral norm'],
    disable_bias=[False, 'disable bias'],
    image_channels=[3, 'image channels'],
    g_channels=[64, 'channel width multiplier'],
    hidden_channels=[32, 'dense block output channel width'],
    num_blocks=[7, 'number of residual blocks'],
    num_rd=[3, 'number of residual dense block in one residual in '
               'residual dense block'],
    num_conv=[5, 'number of conv layer in dense block'],
    g_norm_name=['', 'normalization layer name (fixed: none in RRDB)'],
    g_act_name=['lrelu', 'activation function name'],
    num_scale=[2, 'number of scale'],
    d_channels=[32, 'channel width multiplier'],
    num_layers=[3, 'number of layers'],
    d_norm_name=['in', 'normalization layer name'],
    d_act_name=['lrelu', 'activation function name'],
    lr=[0.0002, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    adv_lambda=[0.001, 'lambda for adversarial loss'],
    vgg_lambda=[1., 'lambda for perceptual loss'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('ESRGAN', ESRGAN_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G, D (SRGAN's) and None (no EMA copy) on `device` (default `cuda`),
    weights drawn from `seed`, computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    G = Generator(int(args.scale), args.image_channels, args.g_channels, args.hidden_channels,
                  args.num_blocks, args.num_rd, args.num_conv, not args.disable_sn,
                  args.g_act_name, not args.disable_bias, srgan.compute_dtype(args), g)
    return G.to(device), srgan.build_discriminator(args, g).to(device), None


def build_training(args, device=None, seed=0, test_batch=None):
    '''Everything one ESRGAN step needs, from `seed`
    (`SRGAN/utils.py:build_recipe` with the relativistic loss).'''
    G, D, _ = build_models(args, device, seed)
    return srgan.build_recipe(G, D, args, next(G.parameters()).device, test_batch, True)


def main(parser):
    parser = add_args(parser, ESRGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader, test_batch = paired.load_task(args, 'sr')
    max_iters = default_max_iters(args, loader)
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed, test_batch=test_batch)
    paired.run_paired('ESRGAN', run, args, accel, loader, max_iters, nrow=9)
