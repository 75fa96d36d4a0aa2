'''FID-50k CLI: generated samples from a trained G vs a dataset.

    python -m animeface_tpu_torch.metrics.fid_cli \
        --model StyleGAN2 --weights path/to/result/G_50000.pt \
        --dataset animeface --image-size 256 --num-samples 50000

Counterpart of `animeface_tpu/metrics/fid_cli.py`. `--weights` is a
`G_<step>.pt` that `python -m animeface_tpu_torch StyleGAN2` wrote (G_ema's
state dict); G runs in bf16, z and its noise maps are drawn from a
`torch.Generator` seeded from `--seed`, and the real stream is the port's
`build_loader`, cycled. Runs on `cuda`, or on the CPU under
`ANIMEFACE_PLATFORM=cpu`; with neither it exits 1.

Requires ANIMEFACE_INCEPTION_WEIGHTS (see tools/convert_inception_weights.py).
With random Inception weights the features collapse to near constants
(untrained BatchNorm stacks are contractive), so FID and KID read about 0
for any pair of streams: the numbers mean something only with the
converted pytorch-fid checkpoint.
'''

from __future__ import annotations

import argparse
import sys

import torch


def generator_batches(sample_fn, num_samples: int, batch_size: int, seed: int, device):
    '''`sample_fn(generator)` batches, from a generator seeded `seed`, until
    `num_samples` images.'''
    gen = torch.Generator(device=device).manual_seed(seed)
    n = 0
    while n < num_samples:
        yield sample_fn(gen)
        n += batch_size


def parse_args(argv=None):
    p = argparse.ArgumentParser(description='FID-50k harness')
    p.add_argument('--model', default='StyleGAN2',
                   help='implementation name (StyleGAN2 supported natively)')
    p.add_argument('--weights', required=True, help='G_<step>.pt of the training CLI')
    p.add_argument('--dataset', default='animeface')
    p.add_argument('--data-root', default=None)
    p.add_argument('--image-size', type=int, default=256)
    p.add_argument('--num-samples', type=int, default=50_000)
    p.add_argument('--batch-size', type=int, default=64)
    p.add_argument('--style-dim', type=int, default=512)
    p.add_argument('--channels', type=int, default=32)
    p.add_argument('--max-channels', type=int, default=512)
    p.add_argument('--map-num-layers', type=int, default=8,
                   help='mapping depth (8 for the published checkpoint)')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--kid', action='store_true', help='also report KID')
    p.add_argument('--synthetic-data', action='store_true',
                   help='real stream from the procedural synthetic dataset '
                        '(runbook dry-run / no datasets mounted)')
    return p.parse_args(argv)


def main(argv=None):
    '''Prints `FID-<k>k: ...` (and `KID-<k>k: ...` with `--kid`); returns
    {'fid': ..., 'kid': ...}.'''
    args = parse_args(argv)

    from animeface_tpu_torch.checkpoint import load_model
    from animeface_tpu_torch.dataset import build_loader
    from animeface_tpu_torch.implementations.StyleGAN2.model import Generator
    from animeface_tpu_torch.metrics.fid import _feature_stream, compute_fid, compute_kid
    from animeface_tpu_torch.metrics.inception import make_extractor
    from animeface_tpu_torch.nnutils.accelerate import Accelerator, default_device
    from animeface_tpu_torch.utils import EasyDict

    try:
        device = default_device()
    except RuntimeError as e:
        print(f'error: {e}', file=sys.stderr)
        sys.exit(1)
    accel = Accelerator(device)

    G = Generator(image_size=args.image_size, style_dim=args.style_dim,
                  channels=args.channels, max_channels=args.max_channels,
                  map_num_layers=args.map_num_layers, dtype=torch.bfloat16)
    G = load_model(args.weights, G.to(device)).eval().requires_grad_(False)

    @torch.no_grad()
    def sample_fn(gen):
        z = torch.randn((args.batch_size, args.style_dim), generator=gen, device=device)
        images, _ = G(z, noise=gen)
        return images

    loader_args = EasyDict(
        dataset=args.dataset, data_root=args.data_root,
        synthetic_data=args.synthetic_data,
        image_size=args.image_size, batch_size=args.batch_size,
        min_year=None, num_images=None, seed=args.seed)
    loader = build_loader(loader_args, 'image')

    def real_stream():
        while True:
            yield from accel.iter_loader(loader)

    extract = make_extractor(device=device)
    fid = compute_fid(real_stream(),
                      generator_batches(sample_fn, args.num_samples, args.batch_size,
                                        args.seed, device),
                      extract, num_samples=args.num_samples, verbose=True)
    print(f'FID-{args.num_samples // 1000}k: {fid:.4f}')
    out = {'fid': fid, 'kid': None}

    if args.kid:
        # KID needs raw feature matrices; cap at the StyleGAN2-ADA default
        # subset budget (100 x 1000) per stream
        n_kid = min(args.num_samples, 10_000)
        real_f = torch.cat(list(_feature_stream(real_stream(), extract, n_kid)))
        fake_f = torch.cat(list(_feature_stream(
            generator_batches(sample_fn, n_kid, args.batch_size, args.seed + 1, device),
            extract, n_kid)))
        out['kid'] = compute_kid(real_f, fake_f, subset_size=min(1000, n_kid), seed=args.seed)
        print(f'KID-{n_kid // 1000}k: {out["kid"]:.6f}')
    return out


if __name__ == '__main__':
    main()
