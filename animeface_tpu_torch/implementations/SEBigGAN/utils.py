'''The SEBigGAN recipe's training step in PyTorch: hinge loss and the
consistency-regularization family over DiffAugment views and latent
perturbations (ICR at the defaults).

Counterpart of `animeface_tpu/implementations/SEBigGAN/utils.py`
(`build_train_step`, `train`, the CLI schema of `main`). Semantics kept:
  * the draws: z, n = N(0, 1) * noise_sigma, and DiffAugment's for `a1`
    (the D phase's fake and, the same draws again, the G phase's fake) and
    `a2` (the real); with `--policy ''` no augmentation;
  * the D phase: G on z, then on z + n, as two calls; then D in five calls,
    each from the buffers the previous one left, on real, real_aug, fake,
    fake_aug, fake_n; hinge loss plus each consistency MSE whose lambda is
    > 0 (real_aug/real, fake_aug/fake, fake_n/fake);
  * the G phase from the PRE-step G buffers (not the D phase's): G on z,
    then on z + n; the loss g_loss(D(a1(f))) - latent_g_lambda * MSE(f,
    f_n) (the MSE is subtracted); D's updates in the phase are dropped and
    G keeps the phase's;
  * G_ema averages G's parameters AND buffers (running statistics, every
    spectral norm's u) at 0.999, as JAX's `update_ema` over
    {'params', 'batch_stats'};
  * `apply_init(..., 'ortho')` on G and on D after construction, each from
    a generator of its own; Adam (G 5e-5, D 2e-4, betas (0, 0.999), eps
    1e-8); samples from G_ema with train=False.
The step mutates `state` and the modules in place and returns the losses
`d` and `g` as 0-dim tensors without a host sync.
'''

from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.BigGAN.utils import (
    compute_dtype, make_optimizers, make_sampler, run_recipe)
from animeface_tpu_torch.implementations.SEBigGAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.initialize import apply_init
from animeface_tpu_torch.nnutils.loss import HingeLoss
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.nnutils.training import buffers_dropped, step_all_parameters, update_ema
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `SEBigGAN/utils.py:main`, names, defaults and help)
SEBIGGAN_ARGS = dict(
    channels=[64, 'channel_width, multiplier'],
    deep=[False, 'deep model'],
    z_dim=[120, 'input latent dim'],
    g_disable_sn=[False, 'disable spectral norm'],
    g_att_name=['se', 'attention name'],
    g_act_name=['relu', 'activation function name'],
    g_norm_name=['bn', 'normalization layer name'],
    d_disable_sn=[False, 'disable spectral norm'],
    d_att_name=['se', 'attention name'],
    d_act_name=['relu', 'activation function name'],
    g_lr=[0.00005, 'learning rate for G'],
    d_lr=[0.0002, 'learning rate for D'],
    betas=[[0., 0.999], 'betas'],
    real_lambda=[10., 'lambda for consistency regularization on real'],
    fake_lambda=[10., 'lambda for consistency regularization on fake'],
    latent_d_lambda=[5., 'lambda for latent consistency regularization '
                         'on D'],
    latent_g_lambda=[0.5, 'lambda for latent consistency regularization '
                          'on G'],
    noise_sigma=[0.03, 'sigma for added noise in latent consistency '
                       'regularization'],
    policy=['color,translation', 'policy for diffaugmnet'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('SEBigGAN', SEBIGGAN_ARGS, overrides)


def build_models(args, device=None, seed=0):
    '''G, D and the EMA copy of G on `device` (default `cuda`), built from
    `seed`, then redrawn with orthogonal kernels (G from `seed` + 1, D from
    `seed` + 2), computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    dtype = compute_dtype(args)
    G = Generator(image_size=args.image_size, z_dim=args.z_dim, deep=args.deep,
                  channels=args.channels, use_sn=not args.g_disable_sn,
                  att_name=args.g_att_name, act_name=args.g_act_name,
                  norm_name=args.g_norm_name, dtype=dtype, generator=g)
    D = Discriminator(image_size=args.image_size, deep=args.deep, channels=args.channels,
                      use_sn=not args.d_disable_sn, att_name=args.d_att_name,
                      act_name=args.d_act_name, dtype=dtype, generator=g)
    apply_init(G, 'ortho', torch.Generator().manual_seed(int(seed) + 1))
    apply_init(D, 'ortho', torch.Generator().manual_seed(int(seed) + 2))
    G, D = G.to(device), D.to(device)
    return G, D, copy.deepcopy(G).requires_grad_(False)


def draw_step_inputs(G, real, generator, policy, noise_sigma):
    '''Every random draw of one step: z, the latent perturbation `n`
    (already times `noise_sigma`), DiffAugment's draws `a1` (both fakes'
    views) and `a2` (the reals'); no augment draws with `policy` ''.'''
    B, _, H, W = real.shape
    return dict(z=sample_nnoise((B, G.z_dim), generator),
                n=sample_nnoise((B, G.z_dim), generator) * noise_sigma,
                a1=draw_diff_augment(B, H, W, policy, generator),
                a2=draw_diff_augment(B, H, W, policy, generator, real.dtype))


def _mse(a, b):
    return ((a - b) ** 2).mean()


def build_train_step(G, D, G_ema, g_opt, d_opt, loss, policy, lambdas, noise_sigma,
                     ema_decay: float = 0.999):
    '''One ICR iteration (D phase, G phase, EMA over parameters and
    buffers); `lambdas` = (real, fake, latent_d, latent_g). Returns
    `train_step(state, real, draws=None) -> metrics`.'''
    real_l, fake_l, lat_d_l, lat_g_l = lambdas

    def aug(x, draws):
        return diff_augment(x, policy, draws) if policy else x

    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G, real, state['generator'], policy, noise_sigma)
        z, zn = draws['z'], draws['z'] + draws['n']

        # ---------------- D phase (from the pre-step G buffers) ----------------
        g_before = [b.clone() for b in G.buffers()]
        with torch.no_grad():
            fake = G(z, train=True)
            fake_n = G(zn, train=True)
            fake_aug = aug(fake, draws['a1'])
            real_aug = aug(real, draws['a2'])
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_prob = D(real, train=True)
        real_aug_prob = D(real_aug, train=True)
        fake_prob = D(fake, train=True)
        fake_aug_prob = D(fake_aug, train=True)
        fake_n_prob = D(fake_n, train=True)
        d_loss = loss.d_loss(real_prob, fake_prob)
        if real_l > 0:
            d_loss = d_loss + _mse(real_aug_prob, real_prob) * real_l
        if fake_l > 0:
            d_loss = d_loss + _mse(fake_aug_prob, fake_prob) * fake_l
        if lat_d_l > 0:
            d_loss = d_loss + _mse(fake_n_prob, fake_prob) * lat_d_l
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase: G keeps its buffer updates, D's dropped ----------------
        with torch.no_grad():
            for b, v in zip(G.buffers(), g_before):
                b.copy_(v)
        with buffers_dropped(D):
            D.requires_grad_(False)
            g_opt.zero_grad(set_to_none=True)
            f = G(z, train=True)
            f_n = G(zn, train=True)
            g_loss = loss.g_loss(D(aug(f, draws['a1']), train=True))
            if lat_g_l > 0:
                g_loss = g_loss - _mse(f, f_n) * lat_g_l
            g_loss.backward()
            step_all_parameters(g_opt, G)
            D.requires_grad_(True)

        update_ema(G, G_ema, ema_decay, buffers=True)
        state['step'] += 1
        return dict(d=torch.nan_to_num(d_loss.detach()), g=torch.nan_to_num(g_loss.detach()))

    return train_step


def build_training(args, device=None, seed=0):
    '''Everything one SEBigGAN training step needs, from `seed`: returns a
    namespace with G, D, G_ema, the optimizers, `state` (step count, the
    generator the draws come from), `train_step(state, real, draws=None)
    -> metrics` and `sample_fn` (G_ema).'''
    G, D, G_ema = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    state = dict(step=0, generator=make_generator(seed, next(G.parameters()).device))
    train_step = build_train_step(
        G, D, G_ema, g_opt, d_opt, HingeLoss(), args.policy,
        (args.real_lambda, args.fake_lambda, args.latent_d_lambda, args.latent_g_lambda),
        args.noise_sigma)
    return SimpleNamespace(G=G, D=D, G_ema=G_ema, g_opt=g_opt, d_opt=d_opt, state=state,
                           train_step=train_step,
                           sample_fn=make_sampler(G_ema, args.z_dim, seed))


def train(args, max_iters, loader):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return run_recipe(run, args, max_iters, loader, 'SEBigGAN', accel)


def main(parser):
    parser = add_args(parser, SEBIGGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader)
