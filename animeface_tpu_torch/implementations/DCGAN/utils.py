'''The DCGAN recipe in PyTorch: its training step and CLI, and the pieces
the recipes on its trunk share (GAN, WGAN, WGAN-gp).

Counterpart of `animeface_tpu/implementations/DCGAN/utils.py`
(`build_train_step`, `train`, `main`). Semantics kept:
  * the GAN loss; Adam (lr 1e-3, optax's betas (0.9, 0.999) and eps 1e-8)
    for G and D; no EMA: samples and `G_<step>.pt` come from G, sampled in
    eval mode (BatchNorm's running statistics) on 16 fixed latents;
  * the D phase runs G(z) in training mode and keeps its BatchNorm
    updates; D sees the reals and the fakes in two calls (batch statistics
    per call), the fakes' from the reals' running statistics, and keeps
    both updates;
  * the G phase's forwards of G and D run in training mode and their
    updates are dropped (`buffers_dropped`), as JAX discards them; it
    steps G against the D just updated.
The step mutates `state` and the modules in place and returns the losses
as 0-dim tensors without a host sync. The draw z is an input (`draws`), by
default drawn from `state['generator']`.
'''

from __future__ import annotations

import contextlib
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.DCGAN.model import Discriminator, Generator
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import GANLoss
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.trainer import (
    default_max_iters, host_step_counter, run_training)
from animeface_tpu_torch.nnutils.training import buffers_dropped, step_all_parameters, train_state
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (with the global ones: image 128, batch 32)
DCGAN_ARGS = dict(latent_dim=[100, 'latent dimension'])


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('DCGAN', DCGAN_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


def build_models(args, device=None, seed=0):
    '''G and D on `device` (default `cuda`), weights drawn from `seed`,
    computing in bf16 unless `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    G = Generator(latent_dim=args.latent_dim, image_size=args.image_size,
                  dtype=compute_dtype(args), generator=g)
    D = Discriminator(image_size=args.image_size, dtype=compute_dtype(args), generator=g)
    return G.to(device), D.to(device)


def make_optimizers(args, G, D):
    '''Adam(1e-3) for G and for D, optax's defaults otherwise.'''
    return tuple(torch.optim.Adam(m.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
                 for m in (G, D))


def draw_step_inputs(G, real, generator):
    '''The step's random draw: z.'''
    return dict(z=sample_nnoise((real.shape[0], G.latent_dim), generator))


def d_phase(G, D, z, real, d_opt, loss, penalty=None, keep_g_buffers=True):
    '''D's update: the fakes G(z) (G in training mode; its BatchNorm
    updates dropped unless `keep_g_buffers`), D on the reals, then on the
    fakes in a second call, `penalty(real, fake)` added to the loss.
    Returns D's loss.'''
    with torch.no_grad(), (contextlib.nullcontext() if keep_g_buffers
                           else buffers_dropped(G)):
        fake = G(z)
    D.requires_grad_(True)
    d_opt.zero_grad(set_to_none=True)
    d_loss = loss.d_loss(D(real), D(fake))
    if penalty is not None:
        d_loss = d_loss + penalty(real, fake)
    d_loss.backward()
    step_all_parameters(d_opt, D)
    return d_loss


def g_phase(G, D, z, g_opt, loss):
    '''G's update against D, both in training mode, their BatchNorm
    updates dropped. Returns G's loss.'''
    with buffers_dropped(G, D):
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        g_loss = loss.g_loss(D(G(z)))
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)
    return g_loss


def build_train_step(G, D, g_opt, d_opt, loss):
    '''One iteration (D phase, G phase). Returns `train_step(state, real,
    draws=None) -> metrics`.'''
    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G, real, state['generator'])
        d_loss = d_phase(G, D, draws['z'], real, d_opt, loss)
        g_loss = g_phase(G, D, draws['z'], g_opt, loss)
        state['step'] += 1
        return dict(d=d_loss.detach(), g=g_loss.detach())

    return train_step


def assemble_training(G, D, g_opt, d_opt, steps, variant, seed=0):
    '''A `build_training` namespace: G, D, the optimizers, `state` (step
    count, generator on G's device, seeded with `seed`), the variants
    `steps[name]`, `variant(i)`, the name of step i's variant, and
    `train_step(state, real, draws=None) -> metrics`.'''
    state = dict(step=0, generator=make_generator(seed, next(G.parameters()).device))

    def train_step(st, real, draws=None):
        return steps[variant(st['step'])](st, real, draws)

    return SimpleNamespace(G=G, D=D, g_opt=g_opt, d_opt=d_opt, state=state, steps=steps,
                           variant=variant, train_step=train_step)


def build_training(args, device=None, seed=0):
    '''Everything one DCGAN training step needs, from `seed`.'''
    G, D = build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    step = build_train_step(G, D, g_opt, d_opt, GANLoss())
    return assemble_training(G, D, g_opt, d_opt, {'step': step}, lambda i: 'step', seed)


def run_recipe(run, args, accel, max_iters, loader, name, num_test=16, nrow=4):
    '''`run_training` around a `build_training` namespace (shared by GAN,
    WGAN and WGAN-gp): each step's variant from the host step index, grids
    of G in eval mode on `num_test` fixed latents drawn from `args.seed`,
    G's state dict as `G_<step>.pt`.'''
    next_index = host_step_counter()

    def train_step(state, batch):
        i = next_index(state['run'])
        return state, run.steps[run.variant(i)](state['run'], batch)

    const_z = torch.randn((num_test, run.G.latent_dim),
                          generator=torch.Generator().manual_seed(args.seed)).to(accel.device)

    @torch.no_grad()
    def sample_fn(state):
        return state['G'](const_z, train=False)

    return run_training(
        name=name, args=args, accel=accel, state=train_state(run), loader=loader,
        train_step=train_step, sample_fn=sample_fn,
        max_iters=max_iters, save_interval=args.save, nrow=nrow,
        ema_params_path=lambda s: s['G'].state_dict(),
    )


def train(args, max_iters, loader, name='DCGAN'):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return run_recipe(run, args, accel, max_iters, loader, name)


def main(parser):
    parser = add_args(parser, DCGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader)
