'''StyleGAN2(-ADA) training in PyTorch: the step and the recipe's CLI.

Counterpart of `animeface_tpu/implementations/StyleGAN2/utils.py`
(`STYLEGAN2_ARGS`, `pl_lengths`, `build_train_step`, `build_models`,
`make_optimizers`, `train`, `main`; the step assembly of `train` is
`build_training`). Semantics kept:
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
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.StyleGAN2.model import Generator, Discriminator
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.ada import ada_update_p, ada_tick
from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss, r1_regularizer
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.trainer import (
    default_max_iters, host_step_counter, run_training)
from animeface_tpu_torch.nnutils.training import step_all_parameters, train_state, update_ema
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults


def pl_lengths(G, w, noise, pl_noise):
    '''Path length |J^T y| per sample: grad of sum(images * pl_noise) with
    respect to w, with the graph kept for the outer backward. `pl_noise` is
    normal noise / sqrt(H * W) of the images' shape; `noise` G's noise maps.'''
    if not w.requires_grad:
        w = w.detach().requires_grad_(True)
    images = G.synthesize_from_w(w.float(), noise)
    (grads,) = torch.autograd.grad((images * pl_noise).sum(), w, create_graph=True)
    return torch.sqrt((grads * grads).sum(dim=1) + 1e-12)


#: the StyleGAN2 recipe's flags, as the JAX `STYLEGAN2_ARGS`: with the
#: global flags (`utils/argument.py`: image 128, batch 32) the recipe's
#: defaults. The port's D groups its minibatch stddev 'strided' only.
STYLEGAN2_ARGS = dict(
    image_channels=[3, 'number of channels for the generated image'],
    style_dim=[512, 'style feature dimension'],
    channels=[32, 'channel width multiplier'],
    max_channels=[512, 'maximum channels'],
    block_num_conv=[2, 'conv layers per residual block'],
    map_num_layers=[8, 'layers in the mapping network'],
    map_lr=[0.01, 'learning-rate multiplier for the mapping network'],
    disable_map_norm=[False, 'disable pixel norm in mapping network'],
    mbsd_groups=[4, 'groups for minibatch stddev'],
    mbsd_grouping=['strided', 'minibatch-stddev grouping: strided (the only one ported)'],
    lr=[0.001, 'learning rate'],
    beta1=[0., 'beta1'],
    beta2=[0.99, 'beta2'],
    g_k=[8, 'lazy regularization: path length every g_k iters'],
    d_k=[16, 'lazy regularization: R1 every d_k iters'],
    r1_lambda=[10., 'lambda for r1'],
    pl_lambda=[0., 'lambda for path length'],
    policy=['color,translation', 'policy for DiffAugment'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('StyleGAN2', STYLEGAN2_ARGS, overrides)


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
                     policy: str = STYLEGAN2_ARGS['policy'][0]):
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
    if getattr(args, 'mbsd_grouping', 'strided') != 'strided':
        raise NotImplementedError(f'mbsd_grouping={args.mbsd_grouping!r}: the port groups '
                                  "the minibatch stddev 'strided' only")
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


def train(args, max_iters, loader, name='StyleGAN2'):
    '''Train from `args` on `loader` for `max_iters` steps through
    `run_training`: the step's variant from the host step index, samples
    of G_ema on 16 fixed latents (drawn from `args.seed`) with fixed noise,
    G_ema's state dict as `G_<step>.pt`.'''
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    next_index = host_step_counter()

    def train_step(state, batch):
        i = next_index(state['run'])
        return state, run.steps[run.variant(i)](state['run'], batch)

    const_z = torch.randn((16, args.style_dim),
                          generator=torch.Generator().manual_seed(args.seed)).to(accel.device)

    @torch.no_grad()
    def sample_fn(state):
        images, _ = state['G_ema'](const_z, noise=make_generator(args.seed, accel.device))
        return images

    return run_training(
        name=name, args=args, accel=accel, state=train_state(run), loader=loader,
        train_step=train_step, sample_fn=sample_fn,
        max_iters=max_iters, save_interval=args.save,
        ema_params_path=lambda s: s['G_ema'].state_dict(),
    )


def main(parser):
    parser = add_args(parser, STYLEGAN2_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader)
