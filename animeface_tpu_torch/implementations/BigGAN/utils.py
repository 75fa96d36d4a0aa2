'''The BigGAN recipe's training step in PyTorch.

Counterpart of `animeface_tpu/implementations/BigGAN/utils.py`
(`build_train_step`, the models, optimizers and sampler of `train`, the
CLI schema of `main`). Semantics kept:
  * hinge loss; DiffAugment with the policy ('color,translation'): the
    reals, the D-phase fakes and the G-phase fakes each with their own
    draws (ar, af, ag);
  * the buffers (spectral norm's u, BatchNorm's running statistics) thread
    as in JAX: G's forward in the D phase updates G's; D on the augmented
    reals, then on the augmented fakes, as two calls (each one power
    iteration and one set of batch statistics), updates D's in turn; the G
    phase's forwards of G and D run in training mode from those buffers and
    their updates are dropped;
  * Adam (G 2e-4, D 5e-5, betas (0, 0.999), eps 1e-8) stepping every
    parameter every iteration; with `--ema`, G's parameters averaged at
    0.999 and G's buffers copied into G_ema after the D phase;
  * the metrics `g` and `d` through `nan_to_num`;
  * 16 fixed latents sampled with train=False, from G_ema with `--ema`,
    else from G.
The step mutates `state` and the modules in place and returns the losses
as 0-dim tensors without a host sync.
'''

from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.BigGAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.loss import HingeLoss
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.trainer import default_max_iters, run_training
from animeface_tpu_torch.nnutils.training import (
    buffers_dropped, step_all_parameters, train_state, update_ema)
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (JAX `BigGAN/utils.py:main`, names, defaults and help)
BIGGAN_ARGS = dict(
    z_dim=[120, 'latent dimension'],
    channels=[64, 'channel width multiplier'],
    deep=[False, 'use deep model'],
    ema=[False, 'use EMA'],
    disable_sn=[False, 'disable spectral norm'],
    disable_attention=[False, 'disable self-attention'],
    att_name=['sa', 'attention type: sa (self-attention) or ll (lambda)'],
    g_lr=[2e-4, 'G learning rate'],
    d_lr=[5e-5, 'D learning rate'],
    betas=[[0., 0.999], 'betas'],
    policy=['color,translation', 'DiffAugment policy'],
)
#: the sampler's fixed latents (JAX `train`'s const_z)
NUM_SAMPLES = 16


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('BigGAN', BIGGAN_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def build_models(args, device=None, seed=0):
    '''G, D and the EMA copy of G on `device` (default `cuda`), weights
    drawn from `seed`, computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    kw = dict(image_size=args.image_size, channels=args.channels, deep=args.deep,
              use_sn=not args.disable_sn, use_attention=not args.disable_attention,
              att_name=args.att_name, dtype=compute_dtype(args), generator=g)
    G = Generator(z_dim=args.z_dim, **kw).to(device)
    D = Discriminator(**kw).to(device)
    return G, D, copy.deepcopy(G).requires_grad_(False)


def make_optimizers(args, G, D):
    '''Adam for G (g_lr) and for D (d_lr), eps 1e-8 (optax's default).'''
    def adam(module, lr):
        return torch.optim.Adam(module.parameters(), lr=lr, betas=tuple(args.betas), eps=1e-8)
    return adam(G, args.g_lr), adam(D, args.d_lr)


def draw_step_inputs(G, real, generator, policy):
    '''Every random draw of one step: z and DiffAugment's draws for the
    reals (`aug_r`), the D-phase fakes (`aug_f`) and the G-phase fakes
    (`aug_g`).'''
    B, _, H, W = real.shape
    return dict(z=sample_nnoise((B, G.z_dim), generator),
                aug_r=draw_diff_augment(B, H, W, policy, generator, real.dtype),
                aug_f=draw_diff_augment(B, H, W, policy, generator),
                aug_g=draw_diff_augment(B, H, W, policy, generator))


def build_train_step(G, D, G_ema, g_opt, d_opt, loss, policy, use_ema: bool,
                     ema_decay: float = 0.999):
    '''One iteration (D phase, G phase, optional EMA). Returns
    `train_step(state, real, draws=None) -> metrics`.'''

    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G, real, state['generator'], policy)
        z = draws['z']

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = G(z, train=True)
            real_aug = diff_augment(real, policy, draws['aug_r'])
            fake_aug = diff_augment(fake, policy, draws['aug_f'])
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = loss.d_loss(D(real_aug, train=True), D(fake_aug, train=True))
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase (its buffer updates dropped) ----------------
        with buffers_dropped(G, D):
            D.requires_grad_(False)
            g_opt.zero_grad(set_to_none=True)
            fake2 = G(z, train=True)
            g_loss = loss.g_loss(D(diff_augment(fake2, policy, draws['aug_g']), train=True))
            g_loss.backward()
            step_all_parameters(g_opt, G)
            D.requires_grad_(True)

        if use_ema:
            update_ema(G, G_ema, ema_decay)
            with torch.no_grad():
                for e, b in zip(G_ema.buffers(), G.buffers()):
                    e.copy_(b)
        state['step'] += 1
        return dict(g=torch.nan_to_num(g_loss.detach()), d=torch.nan_to_num(d_loss.detach()))

    return train_step


def make_sampler(G, z_dim, seed=0):
    '''The recipe's `sample_fn`: `sample()` runs G with train=False under
    torch.no_grad() on NUM_SAMPLES latents drawn once from `seed` on G's
    device.'''
    device = next(G.parameters()).device
    const_z = sample_nnoise((NUM_SAMPLES, z_dim), make_generator(seed, device))

    def sample():
        with torch.no_grad():
            return G(const_z, train=False)

    return sample


def build_training(args, device=None, seed=0):
    '''Everything one BigGAN training step needs, from `seed`: returns a
    namespace with G, D, G_ema (None without `--ema`), the optimizers,
    `state` (step count, the generator the draws come from),
    `train_step(state, real, draws=None) -> metrics` and `sample_fn`.'''
    G, D, G_ema = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    state = dict(step=0, generator=make_generator(seed, next(G.parameters()).device))
    train_step = build_train_step(G, D, G_ema, g_opt, d_opt, HingeLoss(), args.policy,
                                  args.ema)
    sample_fn = make_sampler(G_ema if args.ema else G, args.z_dim, seed)
    return SimpleNamespace(G=G, D=D, G_ema=G_ema if args.ema else None, g_opt=g_opt,
                           d_opt=d_opt, state=state, train_step=train_step,
                           sample_fn=sample_fn)


def run_recipe(run, args, max_iters, loader, name, accel):
    '''`run_training` around a `build_training` namespace (shared with
    SEBigGAN): grids of `run.sample_fn`, G_ema's state dict (G's without
    an EMA copy) as `G_<step>.pt`.'''
    def train_step(state, batch):
        return state, run.train_step(state['run'], batch)

    return run_training(
        name=name, args=args, accel=accel, state=train_state(run), loader=loader,
        train_step=train_step, sample_fn=lambda state: run.sample_fn(),
        max_iters=max_iters, save_interval=args.save,
        ema_params_path=lambda s: s.get('G_ema', s['G']).state_dict(),
    )


def train(args, max_iters, loader):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return run_recipe(run, args, max_iters, loader, 'BigGAN', accel)


def main(parser):
    parser = add_args(parser, BIGGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader)
