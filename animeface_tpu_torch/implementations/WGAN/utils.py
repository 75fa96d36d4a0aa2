'''WGAN with weight clipping in PyTorch: its steps and CLI.

Counterpart of `animeface_tpu/implementations/WGAN/utils.py`, on DCGAN's
models. Semantics kept:
  * the WGAN loss; optax's RMSprop (`nnutils/optim.py`) at lr 5e-5 for G
    and D; after D's update every D parameter (BatchNorm's scales and
    biases too, not its running statistics) is clipped to +-clip_value;
  * two variants: a critic step (D alone) and a full step (D, then G
    against the updated D); step i is full where (i + 1) % n_critic == 0,
    from the host step index, so a resume keeps the cadence;
  * only a full step keeps G's BatchNorm updates from the D phase's
    forward (a critic step drops them, as JAX's `critic_step` drops
    `g_mut`); D keeps both of its passes' updates; the G phase drops its
    own (`DCGAN/utils.py:g_phase`);
  * a critic step's metrics hold g = 0; samples and `G_<step>.pt` from G
    in eval mode on 25 fixed latents, grids 5 to a row; `epochs` 150 sets
    max_iters when `--max-iters` is unset.
'''

from __future__ import annotations

import torch

from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.DCGAN import utils as dcgan
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import WGANLoss
from animeface_tpu_torch.nnutils.optim import RMSprop
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (with the global ones: image 128, batch 32)
WGAN_ARGS = dict(
    epochs=[150, 'epochs to train'],
    latent_dim=[200, 'dimension of input latent'],
    lr=[0.00005, 'learning rate'],
    n_critic=[5, 'update G only every n_critic steps'],
    clip_value=[0.01, 'clip weights to [-clip_value, clip_value]'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('WGAN', WGAN_ARGS, overrides)


def make_optimizers(args, G, D):
    '''optax's RMSprop(lr) for G and for D.'''
    return RMSprop(G.parameters(), args.lr), RMSprop(D.parameters(), args.lr)


def build_steps(G, D, g_opt, d_opt, loss, clip_value):
    '''The two variants, `{'critic': step, 'full': step}`, each
    `step(state, real, draws=None) -> metrics`.'''
    def d_step(state, real, draws, full):
        d_loss = dcgan.d_phase(G, D, draws['z'], real, d_opt, loss, keep_g_buffers=full)
        with torch.no_grad():
            for p in D.parameters():
                p.clamp_(-clip_value, clip_value)
        state['step'] += 1
        return d_loss.detach()

    return critic_steps(G, D, g_opt, loss, d_step, dcgan.draw_step_inputs)


def critic_steps(G, D, g_opt, loss, d_step, draw):
    '''The critic and full variants around `d_step(state, real, draws, full)
    -> D's loss` (shared with WGAN-gp): the full one adds the G phase, the
    critic one reports g = 0. `draw(G, real, generator)` makes the draws.'''
    def step(full):
        def train_step(state, real, draws=None):
            if draws is None:
                draws = draw(G, real, state['generator'])
            d_loss = d_step(state, real, draws, full)
            g_loss = (dcgan.g_phase(G, D, draws['z'], g_opt, loss).detach() if full
                      else torch.zeros_like(d_loss))
            return dict(d=d_loss, g=g_loss)
        return train_step

    return dict(critic=step(False), full=step(True))


def critic_cadence(n_critic):
    '''`variant(i)`: 'full' where (i + 1) % n_critic == 0, else 'critic'.'''
    return lambda i: 'full' if (i + 1) % n_critic == 0 else 'critic'


def build_training(args, device=None, seed=0):
    '''Everything one WGAN training step needs, from `seed` (the namespace
    of `DCGAN/utils.py:assemble_training`, with the two variants).'''
    G, D = dcgan.build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    steps = build_steps(G, D, g_opt, d_opt, WGANLoss(), args.clip_value)
    return dcgan.assemble_training(G, D, g_opt, d_opt, steps, critic_cadence(args.n_critic),
                                   seed)


def max_iters_of(args, loader) -> int:
    '''`--max-iters`, or `epochs` passes over the loader when it is unset.'''
    return args.max_iters if args.max_iters >= 0 else len(loader) * args.epochs


def train(args, max_iters, loader, name='WGAN'):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return dcgan.run_recipe(run, args, accel, max_iters, loader, name, num_test=25, nrow=5)


def main(parser):
    parser = add_args(parser, WGAN_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    train(args, max_iters_of(args, loader), loader)
