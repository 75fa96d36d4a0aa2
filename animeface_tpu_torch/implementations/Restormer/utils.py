'''The Restormer recipe in PyTorch: line art to colour on NAFNet's
restoration step and loop (`NAFNet/utils.py`: LSGAN on (image ‖ line art)
plus a pixel L1, Adam, no EMA copy).

Counterpart of `animeface_tpu/implementations/Restormer/utils.py`: the CLI
schema of `main` with its names and defaults; `g_norm_name` and
`g_act_name` are parsed and read by nothing (the model's norm is the
LayerNorm, its activation gelu, as in JAX); `--randomize-xdog` only warns,
as in JAX (the xdog pairs are made before training).
'''

from __future__ import annotations

import warnings

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.NAFNet import utils as nafnet
from animeface_tpu_torch.implementations.NAFNet.utils import AUTOTUNE  # noqa: F401  (its loop's)
from animeface_tpu_torch.implementations.Restormer.model import Discriminator, Generator
from animeface_tpu_torch.nnutils import paired
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `Restormer/utils.py:main`, names, defaults and help)
RESTORMER_ARGS = dict(
    num_test=[4, 'eval samples'],
    num_blocks=[[2, 6, 6, 8], 'transformer blocks per scale'],
    num_heads=[[1, 2, 4, 8], 'attention heads per scale'],
    num_refinement_blocks=[4, 'transformer blocks in refinement'],
    ff_expansion=[2.66, 'feed forward expansion ratio'],
    g_channels=[48, 'minimum channel width'],
    g_norm_name=['ln', 'normalization layer name (fixed: ln)'],
    g_act_name=['gelu', 'activation layer name (fixed: gelu)'],
    skip_input=[False, 'if true skip connect input to output'],
    num_layers=[3, 'D layers'],
    d_channels=[64, 'D channel width'],
    max_channels=[512, 'max channels'],
    lr=[0.0002, 'learning rate'],
    betas=[[0.5, 0.999], 'betas'],
    pixel_lambda=[10., 'lambda for pixel L1'],
    randomize_xdog=[False, 'use random xdog parameters'],
)
#: the image's channels (the JAX G's default out_channels)
IMAGE_CHANNELS = 3


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('Restormer', RESTORMER_ARGS, overrides)


def build_models(args, device=None, seed=0, line_channels=nafnet.LINE_CHANNELS):
    '''G, D (NAFNet's, its defaults: 'bn', 'lrelu') and None on `device`
    (default `cuda`), weights drawn from `seed`, bf16 unless
    `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = nafnet.compute_dtype(args)
    G = Generator(tuple(args.num_blocks), tuple(args.num_heads), args.num_refinement_blocks,
                  args.ff_expansion, args.g_channels, args.skip_input, line_channels,
                  IMAGE_CHANNELS, dtype, g).to(device)
    D = Discriminator(IMAGE_CHANNELS + line_channels, args.num_layers, args.d_channels,
                      args.max_channels, dtype=dtype, generator=g).to(device)
    return G, D, None


def build_training(args, device=None, seed=0, test_batch=None):
    '''Restormer's `nafnet.build_restoration` namespace, its models from
    `seed`.'''
    G, D, _ = build_models(args, device, seed, nafnet.line_channels_of(test_batch))
    return nafnet.build_restoration(args, G, D, test_batch)


def main(parser):
    parser = add_args(parser, RESTORMER_ARGS)
    args = parser.parse_args()
    save_args(args)

    if args.randomize_xdog:
        warnings.warn('--randomize-xdog: randomize via tools/preprocess/xdog.py when generating '
                      'the xdog set; the training loader uses precomputed files')
    loader, test_batch = paired.load_task(args, 'xdog')
    nafnet.run_restoration('Restormer', args, build_training, loader, test_batch,
                           default_max_iters(args, loader))
