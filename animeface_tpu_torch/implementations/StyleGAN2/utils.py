'''StyleGAN2(-ADA) training step in PyTorch.

Counterpart of `animeface_tpu/implementations/StyleGAN2/utils.py`
(`pl_lengths`, `build_train_step`, `build_models`, `make_optimizers`, and
the step assembly of `train`: `build_training`). Semantics kept:
  * lazy regularization REPLACES the adversarial loss on penalty steps: D
    does R1 only every d_k steps, G path length only every g_k steps;
  * Adam lr/beta rescale by k/(k+1) when a penalty is on;
  * R1 on the raw reals; the augmentation (by default DiffAugment with the
    recipe's policy) on both reals and fakes before D, each with its own
    draws; the adversarial D pass is one stacked [real; fake] batch whose
    minibatch-stddev groups never mix the two;
  * the adaptive-p controller updates from D(real) on adversarial steps and
    ticks on R1 steps; G EMA every step.

The step mutates `state` in place (modules, optimizers, controller) and
returns the metrics as 0-dim tensors, without a host sync. Every random
draw is an input (`draws`), by default drawn from `state['generator']`.
'''

from __future__ import annotations

import copy
from types import SimpleNamespace

import numpy as np
import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.StyleGAN2.model import Generator, Discriminator
from animeface_tpu_torch.nnutils.ada import ada_update_p, ada_tick
from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss, r1_regularizer
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.training import step_all_parameters, update_ema


def pl_lengths(G, w, noise, pl_noise):
    '''Path length |J^T y| per sample: grad of sum(images * pl_noise) with
    respect to w, with the graph kept for the outer backward. `pl_noise` is
    normal noise / sqrt(H * W) of the images' shape; `noise` G's noise maps.'''
    if not w.requires_grad:
        w = w.detach().requires_grad_(True)
    images = G.synthesize_from_w(w.float(), noise)
    (grads,) = torch.autograd.grad((images * pl_noise).sum(), w, create_graph=True)
    return torch.sqrt((grads * grads).sum(dim=1) + 1e-12)


#: the StyleGAN2 recipe's CLI defaults (JAX `STYLEGAN2_ARGS`), and the
#: global ones it trains with (`utils/argument.py`: image 128, batch 32).
#: The port's D groups its minibatch stddev 'strided' only.
STYLEGAN2_DEFAULTS = dict(
    image_size=128, batch_size=32, image_channels=3, style_dim=512, channels=32,
    max_channels=512, block_num_conv=2, map_num_layers=8, map_lr=0.01,
    disable_map_norm=False, mbsd_groups=4, lr=0.001, beta1=0., beta2=0.99, g_k=8, d_k=16,
    r1_lambda=10., pl_lambda=0., policy='color,translation', no_bf16=False)


def default_args(**overrides):
    '''The recipe's defaults as an argument namespace, with overrides.'''
    unknown = set(overrides) - set(STYLEGAN2_DEFAULTS)
    if unknown:
        raise TypeError(f'unknown StyleGAN2 arguments: {sorted(unknown)}')
    return SimpleNamespace(**dict(STYLEGAN2_DEFAULTS, **overrides))


def draw_step_inputs(G, real, generator, policy=''):
    '''Every random draw of one step, from `generator` (on real's device):
    with a DiffAugment `policy`, `aug_d` for the D phase's stacked [real;
    fake] batch (the first B rows the reals') and `aug_g` for the G phase's
    fakes.'''
    B, C, H, W = real.shape
    return dict(
        z_d=sample_nnoise((B, G.style_dim), generator),
        noise_d=generator,
        z_g=sample_nnoise((B, G.style_dim), generator),
        noise_g=generator,
        pl_noise=sample_nnoise((B, C, H, W), generator, std=1 / np.sqrt(H * W)),
        aug_d=draw_diff_augment(2 * B, H, W, policy, generator),
        aug_g=draw_diff_augment(B, H, W, policy, generator),
    )


def build_train_step(G, D, G_ema, g_opt, d_opt, loss, r1_lambda, pl_lambda,
                     d_k, g_k, ema_decay, do_r1: bool, do_pl: bool,
                     augment_fn=None, ada_enabled: bool = False,
                     policy: str = STYLEGAN2_DEFAULTS['policy']):
    '''One iteration (D phase, G phase, EMA) for one (do_r1, do_pl) variant.

    `augment_fn(images, state) -> images` runs on the D input path (the ADA
    AugmentPipe for StyleGAN2-ADA); default: DiffAugment with `policy`, on
    the draws `aug_d` and `aug_g`. In the D phase it gets the stacked
    [real; fake] batch under `no_grad`, so no backward graph goes through
    it there; in the G phase it is differentiated.
    Returns `train_step(state, real, draws=None) -> metrics`.
    '''
    def augment(images, state, draws, which):
        if augment_fn is None:
            return diff_augment(images, policy, draws[which])
        return augment_fn(images, state)

    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G, real, state['generator'],
                                     policy if augment_fn is None else '')
        B = real.shape[0]

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake, _ = G(draws['z_d'], noise=draws['noise_d'])
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_prob = None
        if do_r1:
            d_loss = r1_regularizer(real, D) * (r1_lambda * d_k)
        else:
            with torch.no_grad():
                both = augment(torch.cat([real.float(), fake.float()]), state, draws, 'aug_d')
            logits = D(both, splits=2)
            real_prob = logits[:B].detach()
            d_loss = loss.d_loss(logits[:B], logits[B:])
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        if do_pl:
            w = G.map_w(draws['z_g'])
            lengths = pl_lengths(G, w, draws['noise_g'], draws['pl_noise'])
            g_loss = ((lengths - state['pl_mean']) ** 2).mean() * (pl_lambda * g_k)
        else:
            fake, _ = G(draws['z_g'], noise=draws['noise_g'])
            g_loss = loss.g_loss(D(augment(fake, state, draws, 'aug_g')))
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
        if do_pl:
            state['pl_mean'] = state['pl_mean'] * 0.99 + lengths.detach().mean() * 0.01

        update_ema(G, G_ema, ema_decay)
        state['step'] += 1
        metrics = dict(G=torch.nan_to_num(g_loss.detach()),
                       D=torch.nan_to_num(d_loss.detach()))
        if ada_enabled:
            state['ada'] = (ada_tick(state['ada']) if do_r1
                            else ada_update_p(state['ada'], real_prob))
            metrics['p'] = state['ada']['p']
        return metrics

    return train_step


def build_models(args, compute_dtype=torch.float32, device=None, seed=0):
    '''G, D and the EMA copy of G on `device` (default `cuda`), weights
    drawn from `seed`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    G = Generator(
        image_size=args.image_size, image_channels=args.image_channels,
        style_dim=args.style_dim, channels=args.channels,
        max_channels=args.max_channels, block_num_conv=args.block_num_conv,
        map_num_layers=args.map_num_layers,
        normalize_latent=not args.disable_map_norm, map_lr=args.map_lr,
        dtype=compute_dtype, generator=g)
    D = Discriminator(
        image_size=args.image_size, image_channels=args.image_channels,
        channels=args.channels, max_channels=args.max_channels,
        block_num_conv=args.block_num_conv, mbsd_groups=args.mbsd_groups,
        dtype=compute_dtype, generator=g)
    G, D = G.to(device), D.to(device)
    G_ema = copy.deepcopy(G).requires_grad_(False)
    return G, D, G_ema


def make_optimizers(args, G, D):
    '''Adam (eps 1e-8) with the lazy-regularization lr/beta rescale.'''
    betas = (args.beta1, args.beta2)

    def adam(params, k, on):
        r = k / (k + 1) if on else 1.0
        return torch.optim.Adam(params, lr=args.lr * r,
                                betas=(betas[0] ** r, betas[1] ** r), eps=1e-8)

    return (adam(G.parameters(), args.g_k, args.pl_lambda > 0),
            adam(D.parameters(), args.d_k, args.r1_lambda > 0))


def build_training(args, device=None, seed=0):
    '''Everything one StyleGAN2 training step needs, from `seed`: returns a
    namespace with G, D, G_ema, the optimizers, `state` (step count,
    generator, pl_mean), the variants `steps[(do_r1, do_pl)]`, `variant(i)`
    and `train_step(state, real, draws=None) -> metrics`, which picks the
    variant of step `state['step']`: R1 at i % d_k == 0 and path length at
    i % g_k == 0, never at step 0, each only with its lambda above 0.'''
    device = resolve_device(device)
    compute_dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    G, D, G_ema = build_models(args, compute_dtype, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    state = dict(pl_mean=torch.zeros((), device=device), step=0,
                 generator=make_generator(seed, device))
    loss = NonSaturatingLoss()
    steps = {(r1, pl): build_train_step(G, D, G_ema, g_opt, d_opt, loss, args.r1_lambda,
                                        args.pl_lambda, args.d_k, args.g_k, 0.999, r1, pl,
                                        policy=args.policy)
             for r1 in (False, True) for pl in (False, True)}

    def variant(i):
        return (bool(args.r1_lambda > 0 and i % args.d_k == 0 and i != 0),
                bool(args.pl_lambda > 0 and i % args.g_k == 0 and i != 0))

    def train_step(st, real, draws=None):
        return steps[variant(st['step'])](st, real, draws)

    return SimpleNamespace(G=G, D=D, G_ema=G_ema, g_opt=g_opt, d_opt=d_opt, state=state,
                           steps=steps, variant=variant, train_step=train_step)
