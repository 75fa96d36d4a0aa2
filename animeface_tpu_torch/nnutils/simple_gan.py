'''The generic unconditional-GAN step and loop, in PyTorch.

Counterpart of `animeface_tpu/nnutils/simple_gan.py` (`build_adv_step`,
`run_simple_gan`), the trunk of TransGAN, HiT, ConvNeXt and VAN. Semantics
kept:
  * the D phase: G(z) without gradient, D on the DiffAugmented reals and
    on the DiffAugmented fakes, each with its own draws (aug_r, aug_f);
    with `do_r1` and gp_lambda > 0, R1 on the raw reals (float32) times
    gp_lambda;
  * the G phase runs G again from the same z (the same dropout masks as
    the D phase's G call) against the D just updated, on a third set of
    augment draws (aug_g);
  * D's dropout: one mask source for each D forward (reals, fakes, the G
    phase); R1's forward takes the reals' source, as JAX passes R1 the
    reals' rngs;
  * Adam steps every parameter every iteration; with `use_ema`, G_ema
    moves by `ema_decay` after the G phase; the losses come back through
    `nan_to_num`;
  * the variants: R1 at the steps where step % gp_every == 0 (gp_lambda >
    0), counted from the state's step, so a resume keeps the cadence;
  * the sampler runs G_ema (G without an EMA copy) on `num_test` fixed
    latents without dropout (flax without a 'dropout' rng, torch's eval).
The draws are inputs (`draws`): z, the three augment draws and, for a
model with dropout, the dropout seeds (`g_dropout`, `d_dropout`: one for G,
three for D), each turned into a `torch.Generator` on the device for its
forward. By default they are drawn from `state['generator']` (z, augment)
and `state['dropout_generator']` (seeds, on the CPU: no device sync).
'''

from __future__ import annotations

import copy
from types import SimpleNamespace

import torch

from animeface_tpu_torch.nnutils.diffaugment import diff_augment, draw_diff_augment
from animeface_tpu_torch.nnutils.initialize import apply_init
from animeface_tpu_torch.nnutils.loss import r1_regularizer
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise
from animeface_tpu_torch.nnutils.trainer import run_training
from animeface_tpu_torch.nnutils.training import step_all_parameters, train_state, update_ema


def _seed(generator):
    return int(torch.randint(2 ** 62, (1,), generator=generator))


def draw_step_inputs(latent_dim, real, generator, policy, g_dropout=False, d_dropout=False,
                     dropout_generator=None):
    '''Every random draw of one step: z, DiffAugment's draws for the reals
    (`aug_r`), the D-phase fakes (`aug_f`) and the G-phase fakes (`aug_g`);
    with `g_dropout` G's dropout seed, with `d_dropout` D's three, from
    `dropout_generator` (a CPU generator).'''
    B, _, H, W = real.shape
    draws = dict(z=sample_nnoise((B, latent_dim), generator),
                 aug_r=draw_diff_augment(B, H, W, policy, generator, real.dtype),
                 aug_f=draw_diff_augment(B, H, W, policy, generator),
                 aug_g=draw_diff_augment(B, H, W, policy, generator))
    if g_dropout:
        draws['g_dropout'] = _seed(dropout_generator)
    if d_dropout:
        draws['d_dropout'] = tuple(_seed(dropout_generator) for _ in range(3))
    return draws


def _dropout(draws, key, index, device):
    '''The keyword arguments of a forward: a generator on `device` seeded
    with its dropout seed, if the draws have one.'''
    if key not in draws:
        return {}
    seed = draws[key] if index is None else draws[key][index]
    return {'dropout': make_generator(seed, device)}


def build_adv_step(G, D, G_ema, g_opt, d_opt, loss, policy, gp_lambda, do_r1,
                   ema_decay=0.999, use_ema=True):
    '''One iteration (D phase, G phase, optional EMA). Returns
    `train_step(state, real, draws=None) -> metrics`.'''
    g_dropout = getattr(G, 'has_dropout', False)
    d_dropout = getattr(D, 'has_dropout', False)

    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw_step_inputs(G.latent_dim, real, state['generator'], policy,
                                     g_dropout, d_dropout, state.get('dropout_generator'))
        z, device = draws['z'], real.device

        def d_apply(x, j):
            return D(x, **_dropout(draws, 'd_dropout', j, device))

        # ---------------- D phase ----------------
        with torch.no_grad():
            fake = G(z, **_dropout(draws, 'g_dropout', None, device))
            real_aug = diff_augment(real, policy, draws['aug_r'])
            fake_aug = diff_augment(fake, policy, draws['aug_f'])
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        d_loss = loss.d_loss(d_apply(real_aug, 0), d_apply(fake_aug, 1))
        if do_r1 and gp_lambda > 0:
            d_loss = d_loss + r1_regularizer(real, lambda x: d_apply(x, 0)) * gp_lambda
        d_loss.backward()
        step_all_parameters(d_opt, D)

        # ---------------- G phase ----------------
        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        fake2 = G(z, **_dropout(draws, 'g_dropout', None, device))
        g_loss = loss.g_loss(d_apply(diff_augment(fake2, policy, draws['aug_g']), 2))
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)

        if use_ema:
            update_ema(G, G_ema, ema_decay)
        state['step'] += 1
        return dict(g=torch.nan_to_num(g_loss.detach()), d=torch.nan_to_num(d_loss.detach()))

    return train_step


def init_models(G, D, init_func, seed):
    '''`init_func` (a scheme of `nnutils/initialize.py`) redrawn over G's and
    D's parameters, from generators seeded `seed` + 1 and + 2.'''
    if init_func:
        apply_init(G, init_func, torch.Generator().manual_seed(int(seed) + 1))
        apply_init(D, init_func, torch.Generator().manual_seed(int(seed) + 2))
    return G, D


def ema_copy(G, use_ema):
    '''G's EMA copy (frozen), or None without `use_ema`.'''
    return copy.deepcopy(G).requires_grad_(False) if use_ema else None


def make_sampler(G, latent_dim, num_test, seed=0):
    '''`sample()`: G on `num_test` latents drawn once from `seed` on G's
    device, under torch.no_grad(), without dropout.'''
    const_z = sample_nnoise((num_test, latent_dim),
                            make_generator(seed, next(G.parameters()).device))

    def sample():
        with torch.no_grad():
            return G(const_z)

    return sample


def build_training(G, D, G_ema, g_opt, d_opt, loss, policy, gp_lambda, gp_every,
                   ema_decay=0.999, num_test=16, seed=0):
    '''Everything one step of a simple-GAN recipe needs: a namespace with
    G, D, G_ema (None without an EMA), the optimizers, `state` (step count,
    the generators the draws come from), `steps` {'plain', 'r1'},
    `variant(i)` (step i's variant), `train_step(state, real, draws=None)
    -> metrics` and `sample_fn`.'''
    device = next(G.parameters()).device
    state = dict(step=0, generator=make_generator(seed, device))
    if getattr(G, 'has_dropout', False) or getattr(D, 'has_dropout', False):
        state['dropout_generator'] = torch.Generator().manual_seed(int(seed))
    use_ema = G_ema is not None
    steps = {name: build_adv_step(G, D, G_ema, g_opt, d_opt, loss, policy, gp_lambda,
                                  name == 'r1', ema_decay, use_ema)
             for name in ('plain', 'r1')}

    def variant(i):
        return 'r1' if gp_lambda > 0 and i % gp_every == 0 else 'plain'

    def train_step(st, real, draws=None):
        return steps[variant(st['step'])](st, real, draws)

    sample_fn = make_sampler(G_ema if use_ema else G, G.latent_dim, num_test, seed)
    return SimpleNamespace(G=G, D=D, G_ema=G_ema, g_opt=g_opt, d_opt=d_opt, state=state,
                           steps=steps, variant=variant, train_step=train_step,
                           sample_fn=sample_fn)


def run_simple_gan(name, run, args, accel, loader, max_iters):
    '''`run_training` around a `build_training` namespace: grids of
    `run.sample_fn`, G_ema's state dict (G's without an EMA) as
    `G_<step>.pt`.'''
    def train_step(state, batch):
        return state, run.train_step(state['run'], batch)

    return run_training(
        name=name, args=args, accel=accel, state=train_state(run), loader=loader,
        train_step=train_step, sample_fn=lambda state: run.sample_fn(),
        max_iters=max_iters, save_interval=args.save,
        ema_params_path=lambda s: s.get('G_ema', s['G']).state_dict(),
    )
