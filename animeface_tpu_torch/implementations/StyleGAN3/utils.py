'''StyleGAN3 training step in PyTorch.

Counterpart of `animeface_tpu/implementations/StyleGAN3/utils.py`
(`build_train_step`, `build_models`, `init_state`, `make_optimizers`, and
the step assembly of `train`: `build_training`). Semantics kept:
  * non-saturating loss with ADDITIVE R1 (times gp_lambda) on R1 steps,
    taken on the raw reals; the caller picks the variant per step;
  * the augmentation (by default DiffAugment with the recipe's policy) on
    the reals and the fakes, each with its own draws; D sees the augmented
    reals and the augmented fakes in two separate calls, so
    minibatch-stddev statistics are per call;
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
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.StyleGAN3.model import Generator, Discriminator
from animeface_tpu_torch.nnutils.ada import ada_update_p
from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss, r1_regularizer
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.training import step_all_parameters, update_ema

#: the StyleGAN3 recipe's CLI defaults (JAX `STYLEGAN3_ARGS` and the
#: recipe's DiffAugment `policy`), and the global ones it trains with
#: (`utils/argument.py`: image 128, batch 32)
STYLEGAN3_DEFAULTS = dict(
    image_size=128, batch_size=32, image_channels=3, latent_dim=512, style_dim=512,
    num_layers=14, map_num_layers=2, channels=32, max_channels=512, kernel_size=3,
    no_pixel_norm=False, output_scale=0.25, margin_size=10, first_cutoff=2.,
    first_stopband=2 ** 2.1, last_stopband_rel=2 ** 0.3, d_channels=32,
    d_max_channels=512, mbsd_group_size=4, mbsd_channels=1, bottom=4,
    gaus_filter_size=4, lr=0.0025, map_lr_scale=0.01, betas=(0., 0.99),
    gp_lambda=3., gp_every=16, policy='color,translation', no_bf16=False)


def default_args(**overrides):
    '''The recipe's defaults as an argument namespace, with overrides.'''
    unknown = set(overrides) - set(STYLEGAN3_DEFAULTS)
    if unknown:
        raise TypeError(f'unknown StyleGAN3 arguments: {sorted(unknown)}')
    return SimpleNamespace(**dict(STYLEGAN3_DEFAULTS, **overrides))


def draw_step_inputs(G, real, generator, policy=None):
    '''Every random draw of one step: z, and with a DiffAugment `policy`
    the reals' draws `aug_r` and the fakes' `aug_f` (the G phase reuses
    them); with none, `aug`, the generator a caller's augment_fn draws
    from (rewound for the G phase, so the fakes replay their draws).'''
    B, _, H, W = real.shape
    z = sample_nnoise((B, G.latent_dim), generator)
    if policy is None:
        return dict(z=z, aug=generator)
    return dict(z=z, aug_r=draw_diff_augment(B, H, W, policy, generator, real.dtype),
                aug_f=draw_diff_augment(B, H, W, policy, generator))


def _generator_state(key):
    return key.get_state() if isinstance(key, torch.Generator) else None


def build_train_step(G, D, G_ema, g_opt, d_opt, loss, gp_lambda, do_r1: bool,
                     augment_fn=None, ema_decay: float = 0.999, ada_enabled: bool = False,
                     policy: str = STYLEGAN3_DEFAULTS['policy']):
    '''One iteration (D phase, G phase, EMA) for one variant (do_r1).

    `augment_fn(key, images, state) -> images` runs on D's inputs (the ADA
    AugmentPipe for the ADA recipe), with `key` = `draws['aug']` for the
    reals and the fakes; default: DiffAugment with `policy`, on the draws
    `aug_r` (reals) and `aug_f` (fakes, in both phases).
    Returns `train_step(state, real, draws=None) -> metrics`.
    '''
    moments = G.moment_buffers()
    diffaugment = augment_fn is None
    if diffaugment:
        def augment_fn(key, images, state):
            return diff_augment(images, policy, key)

    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G, real, state['generator'],
                                     policy if diffaugment else None)
        z = draws['z']
        key_r, key_f = ((draws['aug_r'], draws['aug_f']) if diffaugment
                        else (draws['aug'], draws['aug']))

        # ---------------- D phase ----------------
        before = [m.clone() for m in moments]
        with torch.no_grad():
            fake = G(z, train=True)
            real_aug = augment_fn(key_r, real, state)
            replay = _generator_state(key_f)
            fake_aug = augment_fn(key_f, fake, state)
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
            key_f.set_state(replay)
        g_loss = loss.g_loss(D(augment_fn(key_f, fake2, state)))
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


def build_training(args, device=None, seed=0, augment_fn=None, ada_enabled=False):
    '''Everything one StyleGAN3 training step needs, from `seed`: the models
    of `build_models` (bf16 unless `args.no_bf16`) in `assemble_training`.'''
    device = resolve_device(device)
    compute_dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    G, D, G_ema = build_models(args, compute_dtype, device, seed)
    return assemble_training(args, G, D, G_ema, seed, augment_fn, ada_enabled)


def assemble_training(args, G, D, G_ema, seed=0, augment_fn=None, ada_enabled=False):
    '''The step around given models: returns a namespace with G, D, G_ema,
    the optimizers, `state` (step count, generator on G's device, seeded
    with `seed`), the two variants `steps[do_r1]`, `uses_r1(i)` and
    `train_step(state, real, draws=None) -> metrics`, which picks the
    additive-R1 variant where step % gp_every == 0. The augmentation is
    DiffAugment with `args.policy` unless `augment_fn` is given.'''
    g_opt, d_opt = make_optimizers(args, G, D)
    state = init_state(next(G.parameters()).device, seed)
    loss = NonSaturatingLoss()
    policy = args.policy if augment_fn is None else ''
    steps = {do_r1: build_train_step(G, D, G_ema, g_opt, d_opt, loss, args.gp_lambda, do_r1,
                                     augment_fn, ada_enabled=ada_enabled, policy=policy)
             for do_r1 in (False, True)}

    def uses_r1(i):
        return args.gp_lambda > 0 and i % args.gp_every == 0

    def train_step(st, real, draws=None):
        return steps[uses_r1(st['step'])](st, real, draws)

    return SimpleNamespace(G=G, D=D, G_ema=G_ema, g_opt=g_opt, d_opt=d_opt, state=state,
                           steps=steps, uses_r1=uses_r1, train_step=train_step)
