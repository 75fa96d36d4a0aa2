'''The ConvNeXt GAN recipe in PyTorch: its models, optimizers and CLI on the
simple-GAN trunk (`nnutils/simple_gan.py`).

Counterpart of `animeface_tpu/implementations/ConvNeXt/utils.py`: the
`add_args` schema (names and defaults, with the D-trunk knobs `d_depths`
and `d_dims`); the non-saturating loss with R1 (`gp_lambda`) every step;
no DiffAugment; Adam (lr, betas, eps 1e-8), with `--ttur` G at lr / 2
and D at lr * 2; N(0, 0.02) redrawn over the kernels (`init_func`
'N002'); the EMA of G sampled; no cuDNN autotuning (`AUTOTUNE`).
'''

from __future__ import annotations

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.ConvNeXt.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import simple_gan
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `ConvNeXt/utils.py:main`, names and defaults)
CONVNEXT_ARGS = dict(
    num_test=[16],
    image_channels=[3],
    latent_dim=[128],
    bottom=[4],
    channels=[96],
    max_channels=[int],
    block_type=['convnext'],
    blocks_per_scale=[2],
    lr=[0.0001],
    betas=[[0.5, 0.99]],
    ttur=[False],
    gp_lambda=[10.],
    d_depths=[[3, 3, 9, 3], 'D blocks per stage'],
    d_dims=[[96, 192, 384, 768], 'D dims per stage'],
)
#: R1 every step, no augmentation, the kernels' init (the JAX recipe's
#: `run_simple_gan` arguments)
GP_EVERY, POLICY, INIT_FUNC = 1, '', 'N002'
#: no cuDNN autotuning: R1's double backward of the depthwise convs runs one
#: convolution per channel, and autotuning those shapes took 65.67 s
#: (ConvNeXt) and 52.25 s (VAN) of a run's first step on an H100 without
#: a faster step after it
AUTOTUNE = False


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('ConvNeXt', CONVNEXT_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def build_models(args, device=None, seed=0):
    '''G, D and G_ema on `device` (default `cuda`), weights drawn from
    `seed` and redrawn N(0, 0.02), computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = compute_dtype(args)
    G = Generator(latent_dim=args.latent_dim, image_size=args.image_size, bottom=args.bottom,
                  channels=args.channels, max_channels=args.max_channels,
                  block_type=args.block_type, blocks_per_scale=args.blocks_per_scale,
                  out_channels=args.image_channels, dtype=dtype, generator=g)
    D = Discriminator(in_channels=args.image_channels, depths=tuple(args.d_depths),
                      dims=tuple(args.d_dims), dtype=dtype, generator=g)
    G, D = simple_gan.init_models(G, D, INIT_FUNC, seed)
    G, D = G.to(device), D.to(device)
    return G, D, simple_gan.ema_copy(G, True)


def make_optimizers(args, G, D):
    '''Adam for G and D at lr (TTUR: lr / 2 and lr * 2), betas, eps 1e-8.'''
    g_lr, d_lr = (args.lr / 2, args.lr * 2) if args.ttur else (args.lr, args.lr)
    return tuple(torch.optim.Adam(m.parameters(), lr=lr, betas=tuple(args.betas), eps=1e-8)
                 for m, lr in ((G, g_lr), (D, d_lr)))


def build_step(args, G, D, G_ema, g_opt, d_opt, do_r1):
    '''One step of the recipe's variant with (`do_r1`) or without R1.'''
    return simple_gan.build_adv_step(G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), POLICY,
                                     args.gp_lambda, do_r1)


def build_training(args, device=None, seed=0):
    '''Everything one ConvNeXt training step needs, from `seed`
    (`simple_gan.build_training`).'''
    G, D, G_ema = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    return simple_gan.build_training(G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), POLICY,
                                     args.gp_lambda, GP_EVERY, num_test=args.num_test, seed=seed)


def main(parser):
    parser = add_args(parser, CONVNEXT_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    accel = Accelerator(bf16=not args.no_bf16, autotune=AUTOTUNE)
    run = build_training(args, accel.device, seed=args.seed)
    simple_gan.run_simple_gan('ConvNeXt', run, args, accel, loader, max_iters)
