'''The HiT recipe in PyTorch: its models, optimizers and CLI on the
simple-GAN trunk (`nnutils/simple_gan.py`).

Counterpart of `animeface_tpu/implementations/HiT/utils.py`: the `add_args`
schema (names, defaults, help); the arch presets 's', 'b', 'l'
(`set_args_by_arch`) and the 128px trim of one stage (`adjust_by_size`),
verbatim; the per-stage lists extended with their last entry (or cut) to
the stages the image size needs, the low (attention) stages at most all
but the last; D's bottom min(8, image_size / 2); the non-saturating loss
with R1 every `gp_every` steps when gp_lambda > 0 (0 by default);
DiffAugment with `--policy`; Adam (lr, betas, eps 1e-8); `init_func`
(xavier by default) redrawn over G and D; an EMA only with `--ema`.
'''

from __future__ import annotations

import math

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.HiT.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import simple_gan
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `HiT/utils.py:main`, names, defaults and help)
HIT_ARGS = dict(
    num_test=[16, 'number of test images'],
    arch=[str, 'architecture. one of "s", "b" or "l"'],
    latent_dim=[128, 'input latent dim'],
    dims=[[512, 512, 256, 128, 64, 64], 'channel dims per stage'],
    bottom=[8, 'bottom token-grid width'],
    low_stages=[4, 'number of low-res (attention) stages'],
    num_heads=[[16, 8, 4, 4, 4, 4], 'attention heads per stage'],
    num_blocks=[[2, 2, 2, 2, 2, 2], 'blocks per stage'],
    patch_sizes=[[4, 4, 8, 8], 'MAA patch sizes'],
    channels=[32, 'D channel width multiplier'],
    max_channels=[512, 'D maximum channel width'],
    act_name=['lrelu', 'D activation function name'],
    ema=[False, 'use EMA'],
    init_func=['xavier', 'one of "N01", "N002", "xavier" or "kaiming"'],
    lr=[1e-4, 'learning rate'],
    betas=[[0.5, 0.99], 'betas'],
    gp_lambda=[0., 'lambda for gradient penalty'],
    gp_every=[16, 'R1 every N steps (TPU lazy-reg extra)'],
    policy=['color,translation', 'policy for diffaugment'],
)


def set_args_by_arch(args):
    '''The arch presets (JAX `set_args_by_arch`, verbatim tables).'''
    args.bottom = 8
    args.low_stages = 4
    args.num_heads = [16, 8, 4, 4, 4, 4]
    args.patch_sizes = [4, 4, 8, 8]
    if args.arch == 's':
        args.dims = [512, 256, 128, 64, 32, 32]
        args.num_blocks = [2, 2, 1, 1, 1, 1]
    if args.arch == 'b':
        args.dims = [512, 512, 256, 128, 64, 64]
        args.num_blocks = [2, 2, 2, 2, 2, 2]
    if args.arch == 'l':
        args.dims = [1024, 512, 256, 128, 128, 128]
        args.num_blocks = [2, 2, 2, 2, 2, 2]
    return args


def adjust_by_size(args):
    '''One stage trimmed at 128px (JAX `adjust_by_size`).'''
    if args.image_size == 128:
        args.dims = args.dims[:-1]
        args.num_heads = args.num_heads[:-1]
        args.num_blocks = args.num_blocks[:-1]
    return args


def default_args(**overrides):
    '''The recipe's parsed defaults with overrides, then the arch preset
    (if `arch` is set) and the 128px trim, as `main` applies them.'''
    args = recipe_defaults('HiT', HIT_ARGS, overrides)
    if args.arch is not None:
        args = set_args_by_arch(args)
    return adjust_by_size(args)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def stage_config(args):
    '''(dims, heads, blocks, low stages, patch sizes) for the image size.'''
    n = int(math.log2(args.image_size) - math.log2(args.bottom)) + 1

    def fit(values):
        return tuple((list(values) + [values[-1]] * n)[:n])
    low = min(args.low_stages, n - 1)
    patches = tuple((list(args.patch_sizes) + [args.patch_sizes[-1]] * low)[:low])
    return fit(args.dims), fit(args.num_heads), fit(args.num_blocks), low, patches


def build_models(args, device=None, seed=0):
    '''G, D and G_ema (None without `--ema`) on `device` (default `cuda`),
    weights drawn from `seed` and redrawn with `init_func`, computing in
    bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = compute_dtype(args)
    dims, heads, blocks, low, patches = stage_config(args)
    G = Generator(latent_dim=args.latent_dim, dims=dims, bottom=args.bottom, low_stages=low,
                  num_heads=heads, num_blocks=blocks, patch_sizes=patches, dtype=dtype,
                  generator=g)
    D = Discriminator(image_size=args.image_size, channels=args.channels,
                      max_channels=args.max_channels, act_name=args.act_name,
                      bottom=min(8, args.image_size // 2), dtype=dtype, generator=g)
    G, D = simple_gan.init_models(G, D, args.init_func, seed)
    G, D = G.to(device), D.to(device)
    return G, D, simple_gan.ema_copy(G, args.ema)


def make_optimizers(args, G, D):
    '''Adam for G and D at lr, betas, eps 1e-8.'''
    return tuple(torch.optim.Adam(m.parameters(), lr=args.lr, betas=tuple(args.betas), eps=1e-8)
                 for m in (G, D))


def build_step(args, G, D, G_ema, g_opt, d_opt, do_r1):
    '''One step of the recipe's variant with (`do_r1`) or without R1.'''
    return simple_gan.build_adv_step(G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), args.policy,
                                     args.gp_lambda, do_r1, use_ema=args.ema)


def build_training(args, device=None, seed=0):
    '''Everything one HiT training step needs, from `seed`
    (`simple_gan.build_training`).'''
    G, D, G_ema = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    return simple_gan.build_training(G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), args.policy,
                                     args.gp_lambda, args.gp_every, num_test=args.num_test,
                                     seed=seed)


def main(parser):
    parser = add_args(parser, HIT_ARGS)
    args = parser.parse_args()
    if args.arch is not None:
        args = set_args_by_arch(args)
    args = adjust_by_size(args)
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    simple_gan.run_simple_gan('HiT', run, args, accel, loader, max_iters)
