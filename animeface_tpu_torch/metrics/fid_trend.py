'''In-box FID TREND gate over a training run's retained G snapshots.

Counterpart of `tools/fid_trend.py`. Scores every `G_<step>.pt` that the
port's training CLI wrote into a result directory against the run's
dataset with the fixed-seed random-VGG Frechet distance
(`animeface_tpu_torch.metrics.trend`). Prints one line per snapshot,
writes `trend.json`, and exits 0 when the GATE holds (the final snapshot
scores strictly lower than the first), 1 when it fails, and 2 when it
cannot score (fewer than two snapshots, or no card and neither `--cpu` nor
`ANIMEFACE_PLATFORM=cpu`).

    python -m animeface_tpu_torch.metrics.fid_trend \
        --result-dir .../StyleGAN2/result --model StyleGAN2 \
        --image-size 256 --synthetic-data

    # ADA/StyleGAN3 recipes default latent_dim to 512, not this tool's
    # DCGAN-family default of 100 — pass it explicitly:
    python -m animeface_tpu_torch.metrics.fid_trend \
        --result-dir .../ADA/result --model ADA \
        --image-size 128 --synthetic-data --latent-dim 512

    # PGGAN (the default model): each G_<step>.json sidecar records the
    # phase geometry the snapshot was saved under
    python -m animeface_tpu_torch.metrics.fid_trend \
        --result-dir .../PGGAN/result --image-size 128 --synthetic-data

PGGAN snapshots are progressive: a sidecar `G_<step>.json` beside each
`G_<step>.pt` records its {resolution, depth, mode, alpha}; samples are
drawn at that geometry and resized bilinearly up to `--image-size` (a
snapshot without one is sampled at full depth, mode 's', alpha 1), so
fds across resolutions also reflect the upsampling blur: expect a step at
each growth boundary. `trend.json` records each snapshot's alpha, and its
resolution where its sidecar gives one. The numbers are NOT FID and must
not be compared with published values; the gate is strictly relative.
'''

from __future__ import annotations

import argparse
import glob
import json
import os
import re
import sys

import torch


def pggan_model(args, device):
    '''PGGAN's G at `max_depth` = RESOLUTIONS.index(--image-size), in
    float32; each snapshot sampled at its sidecar's depth, mode and alpha.'''
    import torch.nn.functional as F
    from animeface_tpu_torch.implementations.PGGAN.model import Generator, RESOLUTIONS

    if args.image_size not in RESOLUTIONS:
        raise ValueError(f'PGGAN grows to {RESOLUTIONS}, not {args.image_size}px')
    max_depth = RESOLUTIONS.index(args.image_size)
    G = Generator(latent_dim=args.latent_dim, max_depth=max_depth).to(device)

    @torch.no_grad()
    def sample(gen, snap_meta):
        depth = snap_meta['depth']
        z = torch.randn((args.batch_size, args.latent_dim), generator=gen, device=device)
        images = G(z, max_depth if depth is None else depth, snap_meta.get('mode', 's'),
                   float(snap_meta.get('alpha', 1.0)))
        if images.shape[-1] != args.image_size:
            images = F.interpolate(images, size=(args.image_size, args.image_size),
                                   mode='bilinear', align_corners=False, antialias=False)
        return images

    return G, sample


def stylegan2_model(args, device):
    from animeface_tpu_torch.implementations.StyleGAN2.model import Generator

    G = Generator(image_size=args.image_size, style_dim=args.style_dim,
                  channels=args.channels, max_channels=args.max_channels).to(device)

    @torch.no_grad()
    def sample(gen, snap_meta):
        z = torch.randn((args.batch_size, args.style_dim), generator=gen, device=device)
        return G(z, noise=gen)[0]

    return G, sample


def stylegan3_model(args, device):
    '''StyleGAN3 backbone (also the ADA recipe's): the `G_<step>.pt` state
    dict carries the moment buffers (magnitude EMAs, w_avg) beside the
    weights.'''
    from animeface_tpu_torch.implementations.StyleGAN3.model import Generator

    G = Generator(image_size=args.image_size, latent_dim=args.latent_dim,
                  num_layers=args.num_layers, map_num_layers=args.map_num_layers,
                  channels=args.channels, max_channels=args.max_channels,
                  style_dim=args.style_dim).to(device)

    @torch.no_grad()
    def sample(gen, snap_meta):
        return G(torch.randn((args.batch_size, args.latent_dim), generator=gen, device=device))

    return G, sample


MODELS = {'PGGAN': pggan_model, 'StyleGAN2': stylegan2_model,
          'StyleGAN3': stylegan3_model, 'ADA': stylegan3_model}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--result-dir', required=True)
    p.add_argument('--model', default='PGGAN', choices=sorted(MODELS))
    p.add_argument('--image-size', type=int, required=True)
    p.add_argument('--num-samples', type=int, default=1024)
    p.add_argument('--batch-size', type=int, default=128)
    p.add_argument('--num-images', type=int, default=4096,
                   help='synthetic dataset size for the reference stats')
    p.add_argument('--synthetic-data', action='store_true')
    p.add_argument('--data-root', default=None)
    p.add_argument('--dataset', default='animeface')
    p.add_argument('--latent-dim', type=int, default=100)
    p.add_argument('--style-dim', type=int, default=512)
    p.add_argument('--channels', type=int, default=32)
    p.add_argument('--max-channels', type=int, default=512)
    p.add_argument('--num-layers', type=int, default=14,
                   help='StyleGAN3 synthesis depth')
    p.add_argument('--map-num-layers', type=int, default=2,
                   help='StyleGAN3 mapping depth')
    p.add_argument('--seed', type=int, default=0)
    p.add_argument('--cpu', action='store_true')
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)

    from animeface_tpu_torch.checkpoint import load_model
    from animeface_tpu_torch.dataset import build_loader
    from animeface_tpu_torch.metrics.trend import (
        make_trend_extractor, trend_fd, trend_statistics)
    from animeface_tpu_torch.nnutils.accelerate import Accelerator, default_device
    from animeface_tpu_torch.utils import EasyDict

    try:
        device = torch.device('cpu') if args.cpu else default_device()
    except RuntimeError as e:
        print(f'error: {e}', file=sys.stderr)
        sys.exit(2)

    snaps = []
    for path in glob.glob(os.path.join(args.result_dir, 'G_*.pt')):
        m = re.match(r'G_(\d+)\.pt$', os.path.basename(path))
        if m:
            snaps.append((int(m.group(1)), path))
    snaps.sort()
    if len(snaps) < 2:
        print(f'need >= 2 numbered snapshots in {args.result_dir}, '
              f'found {len(snaps)}', file=sys.stderr)
        sys.exit(2)
    try:
        G, sample = MODELS[args.model](args, device)
    except ValueError as e:
        print(f'error: {e}', file=sys.stderr)
        sys.exit(2)

    accel = Accelerator(device)
    loader_args = EasyDict(
        dataset=args.dataset, data_root=args.data_root,
        synthetic_data=args.synthetic_data, image_size=args.image_size,
        batch_size=args.batch_size, min_year=None,
        num_images=args.num_images, seed=args.seed)
    loader = build_loader(loader_args, 'image')

    def real_stream():
        while True:
            yield from accel.iter_loader(loader)

    extract = make_trend_extractor(device=device)
    ref_stats = trend_statistics(real_stream(), extract, max_samples=args.num_samples)

    def fake_stream(snap_meta):
        gen = torch.Generator(device=device).manual_seed(args.seed + 1)
        while True:
            yield sample(gen, snap_meta)

    results = []
    for step, path in snaps:
        snap_meta = dict(depth=None, mode='s', alpha=1.0)
        sidecar = path[:-len('.pt')] + '.json'
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                snap_meta.update(json.load(f))
        load_model(path, G)
        fd = trend_fd(ref_stats, trend_statistics(
            fake_stream(snap_meta), extract, max_samples=args.num_samples))
        results.append(dict(step=step, fd=fd, **{
            k: snap_meta[k] for k in ('resolution', 'alpha') if k in snap_meta}))
        print(f'[trend] step {step:>7}  fd {fd:12.4f}  '
              f'{snap_meta.get("resolution", args.image_size)}px '
              f'alpha {snap_meta.get("alpha", 1.0):.2f}', flush=True)

    gate_ok = bool(results[-1]['fd'] < results[0]['fd'])
    out = dict(metric='random-vgg frechet trend (relative only)',
               gate='final snapshot fd < first snapshot fd',
               gate_ok=gate_ok, results=results)
    out_path = os.path.join(args.result_dir, 'trend.json')
    with open(out_path, 'w') as f:
        json.dump(out, f, indent=1)
    print(f'[trend] gate {"OK" if gate_ok else "FAILED"} '
          f'({results[0]["fd"]:.4f} -> {results[-1]["fd"]:.4f}); '
          f'wrote {out_path}')
    sys.exit(0 if gate_ok else 1)


if __name__ == '__main__':
    main()
