'''StyleGAN3 training step in PyTorch.

Counterpart of `animeface_tpu/implementations/StyleGAN3/utils.py`
(`build_train_step`, `build_models`, `init_state`, `make_optimizers`).
Semantics kept:
  * non-saturating loss with ADDITIVE R1 (times gp_lambda) on R1 steps,
    taken on the raw reals; the caller picks the variant per step;
  * D sees the augmented reals and the augmented fakes in two separate
    calls, so minibatch-stddev statistics are per call;
  * the G phase draws its fakes from the same z with the pre-step moments
    (the JAX G phase applies `state['G_moments']` and drops its own moment
    update), and augments them with the D-phase fakes' draws (the same key);
    the moments the step keeps are the D-phase forward's;
  * G's mapping trains at lr * map_lr_scale; Adam everywhere; G EMA of the
    parameters every step, with the moments copied to the EMA model;
  * the adaptive-p controller updates from D(real) every step when
    `ada_enabled`.

The step mutates `state` and the modules in place and returns the metrics
as 0-dim tensors, without a host sync. Every random draw is an input
(`draws`), by default drawn from `state['generator']`.
'''

from __future__ import annotations

import copy

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.StyleGAN3.model import Generator, Discriminator
from animeface_tpu_torch.nnutils.ada import ada_update_p
from animeface_tpu_torch.nnutils.loss import r1_regularizer
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.training import step_all_parameters, update_ema

#: the StyleGAN3 recipes' CLI defaults (JAX `STYLEGAN3_ARGS`), and the
#: global ones they train with (`utils/argument.py`: image 128, batch 32)
STYLEGAN3_DEFAULTS = dict(
    image_size=128, batch_size=32, image_channels=3, latent_dim=512, style_dim=512,
    num_layers=14, map_num_layers=2, channels=32, max_channels=512, kernel_size=3,
    no_pixel_norm=False, output_scale=0.25, margin_size=10, first_cutoff=2.,
    first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, d_channels=32,
    d_max_channels=512, mbsd_group_size=4, mbsd_channels=1, bottom=4,
    gaus_filter_size=4, lr=0.0025, map_lr_scale=0.01, betas=(0., 0.99),
    gp_lambda=3., gp_every=16, no_bf16=False)


def draw_step_inputs(G, real, generator):
    '''Every random draw of one step: z, and the generator the augment
    draws from (rewound for the G phase, so the fakes replay their draws).'''
    return dict(z=sample_nnoise((real.shape[0], G.latent_dim), generator), aug=generator)


def _generator_state(key):
    return key.get_state() if isinstance(key, torch.Generator) else None


def build_train_step(G, D, G_ema, g_opt, d_opt, loss, gp_lambda, do_r1: bool, augment_fn,
                     ema_decay: float = 0.999, ada_enabled: bool = False):
    '''One iteration (D phase, G phase, EMA) for one variant (do_r1).

    `augment_fn(key, images, state) -> images` runs on D's inputs; `key`
    is `draws['aug']`. (The JAX recipe's default, DiffAugment, is not
    ported: the caller passes the augmentation.)
    Returns `train_step(state, real, draws=None) -> metrics`.
    '''
    moments = G.moment_buffers()

    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G, real, state['generator'])
        z, key = draws['z'], draws['aug']

        # ---------------- D phase ----------------
        before = [m.clone() for m in moments]
        with torch.no_grad():
            fake = G(z, train=True)
            real_aug = augment_fn(key, real, state)
            replay = _generator_state(key)
            fake_aug = augment_fn(key, fake, state)
        after = [m.clone() for m in moments]
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_prob = D(real_aug)
        d_loss = loss.d_loss(real_prob, D(fake_aug))
        if do_r1:
            d_loss = d_loss + r1_regularizer(real, D) * gp_lambda
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        with torch.no_grad():
            for m, v in zip(moments, before):
                m.copy_(v)
        fake2 = G(z, train=True)
        with torch.no_grad():
            for m, v in zip(moments, after):
                m.copy_(v)
        if replay is not None:
            key.set_state(replay)
        g_loss = loss.g_loss(D(augment_fn(key, fake2, state)))
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)

        update_ema(G, G_ema, ema_decay)
        with torch.no_grad():
            for e, b in zip(G_ema.buffers(), G.buffers()):
                e.copy_(b)
        state['step'] += 1
        metrics = dict(g=torch.nan_to_num(g_loss.detach()),
                       d=torch.nan_to_num(d_loss.detach()))
        if ada_enabled:
            state['ada'] = ada_update_p(state['ada'], real_prob.detach())
            metrics['p'] = state['ada']['p']
        return metrics

    return train_step


def build_models(args, compute_dtype=torch.float32, device=None, seed=0):
    '''G, D and the EMA copy of G on `device` (default `cuda`), weights
    drawn from `seed`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    G = Generator(
        image_size=args.image_size, latent_dim=args.latent_dim, num_layers=args.num_layers,
        map_num_layers=args.map_num_layers, channels=args.channels,
        max_channels=args.max_channels, style_dim=args.style_dim,
        pixel_norm=not args.no_pixel_norm, image_channels=args.image_channels,
        output_scale=args.output_scale, margin_size=args.margin_size,
        first_cutoff=args.first_cutoff, first_stopband=args.first_stopband,
        last_stopband_rel=args.last_stopband_rel, kernel_size=args.kernel_size,
        dtype=compute_dtype, generator=g)
    D = Discriminator(
        image_size=args.image_size, in_channels=args.image_channels,
        channels=args.d_channels, max_channels=args.d_max_channels,
        mbsd_group_size=args.mbsd_group_size, mbsd_channels=args.mbsd_channels,
        bottom=args.bottom, filter_size=args.gaus_filter_size, dtype=compute_dtype,
        generator=g)
    G, D = G.to(device), D.to(device)
    G_ema = copy.deepcopy(G).requires_grad_(False)
    return G, D, G_ema


def init_state(device=None, seed=0):
    '''The step's state besides the modules: the step count and the
    generator the draws come from.'''
    device = resolve_device(device)
    return dict(step=0, generator=make_generator(seed, device))


def make_optimizers(args, G, D):
    '''Adam (eps 1e-8); G's mapping network at lr * map_lr_scale.'''
    betas = tuple(args.betas)
    mapping = [p for name, p in G.named_parameters() if name.startswith('map.')]
    synthesis = [p for name, p in G.named_parameters() if not name.startswith('map.')]
    g_opt = torch.optim.Adam([dict(params=synthesis, lr=args.lr),
                              dict(params=mapping, lr=args.lr * args.map_lr_scale)],
                             betas=betas, eps=1e-8)
    d_opt = torch.optim.Adam(D.parameters(), lr=args.lr, betas=betas, eps=1e-8)
    return g_opt, d_opt
