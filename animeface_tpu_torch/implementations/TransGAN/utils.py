'''The TransGAN recipe in PyTorch: its models, optimizers and CLI on the
simple-GAN trunk (`nnutils/simple_gan.py`).

Counterpart of `animeface_tpu/implementations/TransGAN/utils.py`: the
`add_args` schema (names, defaults, help); `g_depths` extended with its
last entry (or cut) to the number of stages the image size needs; the
non-saturating loss with R1 every `gp_every` steps; DiffAugment with
`--policy`; Adam (lr, beta1, beta2, eps 1e-8), with `--ttur` G at lr / 2
and D at lr * 2; an EMA only with `--ema`; dropout 0.1 in G and D by
default, on in the training step and off in the sampler.
'''

from __future__ import annotations

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.TransGAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import simple_gan
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `TransGAN/utils.py:main`, names, defaults and help)
TRANSGAN_ARGS = dict(
    image_channels=[3, 'channels of the output image'],
    latent_dim=[128, 'dimension of latent input'],
    g_depths=[[5, 4, 2], 'number of transformer blocks per resolution'],
    bottom_width=[8, 'first resolution'],
    g_embed_dim=[1024, 'dimension of embedding in G. times of 4'],
    g_num_heads=[4, 'number of heads in multi-head attention in G'],
    g_mlp_ratio=[4, 'ratio for hidden features in mlp in G'],
    g_use_qkv_bias=[False, 'use bias for query, key and value in G'],
    g_dropout=[0.1, 'dropout probability in G'],
    g_attn_dropout=[0.1, 'dropout probability for heatmap in G'],
    g_act_name=['gelu', 'activation function in G'],
    g_norm_name=['ln', 'normalization layer name in G (fixed: ln)'],
    patch_size=[8, 'size of each patch'],
    d_depth=[7, 'number of encoders in D'],
    d_embed_dim=[384, 'dimension of embedding in D. times of 4'],
    d_num_heads=[4, 'number of heads in multi-head attention in D'],
    d_mlp_ratio=[4, 'ratio for hidden features in mlp in D'],
    d_use_qkv_bias=[False, 'use bias for query, key and value in D'],
    d_dropout=[0.1, 'dropout probability in D'],
    d_attn_dropout=[0.1, 'dropout probability for heatmap in D'],
    d_act_name=['gelu', 'activation function in D'],
    d_norm_name=['ln', 'normalization layer name in D (fixed: ln)'],
    lr=[0.00001, 'learning rate'],
    ttur=[False, 'use TTUR'],
    beta1=[0.5, 'beta1'],
    beta2=[0.999, 'beta2'],
    gp_lambda=[10., 'lambda for gradient penalty'],
    gp_every=[16, 'R1 every N steps (TPU lazy-reg extra)'],
    policy=['color,translation', 'policy for DiffAugment'],
    ema=[False, 'exponential moving average'],
    ema_decay=[0.999, 'decay for EMA'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('TransGAN', TRANSGAN_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def g_depths(args):
    '''`g_depths` extended with its last entry, or cut, to one stage per
    resolution from `bottom_width` to the image size.'''
    need = Generator.depths_len_from_target_width(args.image_size, args.bottom_width)
    depths = list(args.g_depths)
    while len(depths) < need:
        depths.append(depths[-1])
    return tuple(depths[:need])


def build_models(args, device=None, seed=0):
    '''G, D and G_ema (None without `--ema`) on `device` (default `cuda`),
    weights drawn from `seed`, computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = compute_dtype(args)
    G = Generator(depths=g_depths(args), latent_dim=args.latent_dim,
                  image_channels=args.image_channels, bottom_width=args.bottom_width,
                  embed_dim=args.g_embed_dim, num_heads=args.g_num_heads,
                  mlp_ratio=args.g_mlp_ratio, qkv_bias=args.g_use_qkv_bias,
                  dropout=args.g_dropout, attn_dropout=args.g_attn_dropout,
                  act_name=args.g_act_name, dtype=dtype, generator=g).to(device)
    D = Discriminator(depth=args.d_depth, image_size=args.image_size, patch_size=args.patch_size,
                      image_channels=args.image_channels, embed_dim=args.d_embed_dim,
                      num_heads=args.d_num_heads, mlp_ratio=args.d_mlp_ratio,
                      qkv_bias=args.d_use_qkv_bias, dropout=args.d_dropout,
                      attn_dropout=args.d_attn_dropout, act_name=args.d_act_name, dtype=dtype,
                      generator=g).to(device)
    return G, D, simple_gan.ema_copy(G, args.ema)


def make_optimizers(args, G, D):
    '''Adam for G and D at lr (TTUR: lr / 2 and lr * 2), (beta1, beta2), eps 1e-8.'''
    g_lr, d_lr = (args.lr / 2, args.lr * 2) if args.ttur else (args.lr, args.lr)
    return tuple(torch.optim.Adam(m.parameters(), lr=lr, betas=(args.beta1, args.beta2), eps=1e-8)
                 for m, lr in ((G, g_lr), (D, d_lr)))


def build_step(args, G, D, G_ema, g_opt, d_opt, do_r1):
    '''One step of the recipe's variant with (`do_r1`) or without R1.'''
    return simple_gan.build_adv_step(G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), args.policy,
                                     args.gp_lambda, do_r1, args.ema_decay, args.ema)


def build_training(args, device=None, seed=0):
    '''Everything one TransGAN training step needs, from `seed`
    (`simple_gan.build_training`).'''
    G, D, G_ema = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    return simple_gan.build_training(G, D, G_ema, g_opt, d_opt, NonSaturatingLoss(), args.policy,
                                     args.gp_lambda, args.gp_every, args.ema_decay, seed=seed)


def main(parser):
    parser = add_args(parser, TRANSGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    simple_gan.run_simple_gan('TransGAN', run, args, accel, loader, max_iters)
