'''Sampling from saved weights: a grid of StyleGAN2 images.

    python -m animeface_tpu_torch.generate --weights result/G_50000.pt \
        --num 16 --out samples.png [--image-size 256] [--seed 0] \
        [--truncation 0.7] [--mix-seed 1 --mix-layer 8]

Counterpart of `tools/generate.py`, with its flags and its three flows:
  * plain: G(z) with its noise maps;
  * style mixing (`--mix-seed`): z and z2 through the mapping network,
    the layers at or after `--mix-layer` taking z2's style;
  * truncation (`--truncation` below 1, without `--mix-seed`): w pulled
    toward the mean of 4096 mapped latents, w_mean + t * (w - w_mean),
    then the synthesis from w.
`--weights` is a `G_<step>.pt` that `python -m animeface_tpu_torch
StyleGAN2` wrote (G_ema's state dict); G is built with the flags' widths
and 8 mapping layers and runs in bf16. The grid goes through the port's
`save_image`, `--nrow` images a row.

The draws come from `torch.Generator`s: z and then the noise maps from
`--seed`, z2 from `--mix-seed`, the 4096 latents of the mean from
`--seed + 99`. JAX's threefry streams differ from these, so an image of
the port at a seed is not the JAX tool's image at that seed; the
arithmetic is the same (`tests/test_torch_generate.py` injects the draws).
Runs on `cuda`, or on the CPU under `ANIMEFACE_PLATFORM=cpu`; with neither
it exits 1.
'''

from __future__ import annotations

import argparse
import sys

import torch

#: latents averaged for the truncation's mean style
MEAN_LATENTS = 4096


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='sample a grid from saved G weights')
    p.add_argument('--model', default='StyleGAN2', choices=['StyleGAN2'],
                   help='generator family (covers ADA/APA/DiffAugment weights)')
    p.add_argument('--weights', required=True, help='G_<step>.pt of the training CLI')
    p.add_argument('--num', type=int, default=16)
    p.add_argument('--out', default='samples.png')
    p.add_argument('--image-size', type=int, default=256)
    p.add_argument('--style-dim', type=int, default=512)
    p.add_argument('--channels', type=int, default=32)
    p.add_argument('--max-channels', type=int, default=512)
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--truncation', type=float, default=1.0,
                   help='w-space truncation toward the mean style')
    p.add_argument('--mix-seed', type=int, default=None,
                   help='second seed for style mixing')
    p.add_argument('--mix-layer', type=int, default=8,
                   help='first layer taking the second style')
    p.add_argument('--nrow', type=int, default=4)
    return p.parse_args(argv)


def flow(args) -> str:
    ''''mix', 'truncation' or 'plain', as the JAX tool picks them.'''
    if args.mix_seed is not None:
        return 'mix'
    return 'truncation' if args.truncation < 1.0 else 'plain'


def build_generator(args, device, dtype=torch.bfloat16):
    '''The StyleGAN2 G of the flags' widths with `args.weights` loaded, in
    eval mode and frozen, computing in `dtype`.'''
    from animeface_tpu_torch.checkpoint import load_model
    from animeface_tpu_torch.implementations.StyleGAN2.model import Generator

    G = Generator(image_size=args.image_size, style_dim=args.style_dim,
                  channels=args.channels, max_channels=args.max_channels, dtype=dtype)
    return load_model(args.weights, G.to(device), map_location=device).eval().requires_grad_(False)


def draw_inputs(G, args, device):
    '''The flow's draws on `device`: z [num, style_dim] and the noise maps
    (in G's compute dtype) from `--seed`; z2 from `--mix-seed` (mixing);
    the latents of the mean style from `--seed + 99` (truncation).'''
    def generator(seed):
        return torch.Generator(device=device).manual_seed(int(seed))

    g = generator(args.seed)
    shape = (args.num, args.style_dim)
    draws = dict(z=torch.randn(shape, generator=g, device=device))
    draws['noise'] = G._noise(g, args.num)
    kind = flow(args)
    if kind == 'mix':
        draws['z2'] = torch.randn(shape, generator=generator(args.mix_seed), device=device)
    elif kind == 'truncation':
        draws['z_mean'] = torch.randn((MEAN_LATENTS, args.style_dim),
                                      generator=generator(args.seed + 99), device=device)
    return draws


@torch.no_grad()
def sample(G, args, draws):
    '''The flow's images, [num, 3, S, S] float32 in [-1, 1].'''
    kind = flow(args)
    if kind == 'mix':
        images, _ = G((draws['z'], draws['z2']), noise=draws['noise'], injection=args.mix_layer)
    elif kind == 'truncation':
        w = G.map_w(draws['z'])
        w_mean = G.map_w(draws['z_mean']).mean(dim=0, keepdim=True)
        w = w_mean + args.truncation * (w - w_mean)
        images = G.synthesize_from_w(w, noise=draws['noise'])
    else:
        images, _ = G(draws['z'], noise=draws['noise'])
    return images.float()


def main(argv=None):
    '''Writes the grid to `--out`; returns the images (NCHW, on the device).'''
    args = parse_args(argv)

    from animeface_tpu_torch.nnutils.accelerate import default_device
    from animeface_tpu_torch.nnutils.trainer import host_images
    from animeface_tpu_torch.utils import save_image

    try:
        device = default_device()
    except RuntimeError as e:
        print(f'error: {e}', file=sys.stderr)
        sys.exit(1)
    G = build_generator(args, device)
    images = sample(G, args, draw_inputs(G, args, device))
    save_image(host_images(images), args.out, nrow=args.nrow)
    print(f'wrote {args.num} samples -> {args.out}')
    return images


if __name__ == '__main__':
    main()
