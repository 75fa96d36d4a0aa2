'''WGAN-gp in PyTorch: its steps and CLI.

Counterpart of `animeface_tpu/implementations/WGAN_gp/utils.py`, on
DCGAN's models, with WGAN's cadence (`WGAN/utils.py:critic_steps`,
`critic_cadence`) and BatchNorm rules, Adam (lr 5e-5, betas (0.5, 0.999))
for G and D, gp_gamma 10, n_critic 5, `epochs` 150, 25 fixed latents with
grids 5 to a row. D's loss adds gp_gamma times the recipe's own
per-sample penalty (`per_sample_gradient_penalty`): x_hat mixes the reals
and the detached fakes by alpha ~ U[0, 1) per sample (a draw, [B, 1, 1,
1]), cast to float32; the inner gradient of sum(D(x_hat)) runs through D in
training mode (x_hat's batch statistics, its running-statistics update
dropped) with `create_graph=True`, so D's update differentiates through
it, BatchNorm included.
'''

from __future__ import annotations

import torch

from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.DCGAN import utils as dcgan
from animeface_tpu_torch.implementations.WGAN.utils import (
    critic_cadence, critic_steps, max_iters_of)
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import WGANLoss
from animeface_tpu_torch.nnutils.rng import sample_unoise
from animeface_tpu_torch.nnutils.training import buffers_dropped
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags (with the global ones: image 128, batch 32)
WGAN_GP_ARGS = dict(
    epochs=[150, 'epochs to train'],
    latent_dim=[200, 'dimension of input latent'],
    lr=[5e-5, 'learning rate for both G and D'],
    beta1=[0.5, 'beta1'],
    beta2=[0.999, 'beta2'],
    n_critic=[5, 'train G only every n_critic steps'],
    gp_gamma=[10., 'gamma for gradient penalty'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('WGAN_gp', WGAN_GP_ARGS, overrides)


def make_optimizers(args, G, D):
    '''Adam(lr, (beta1, beta2), eps 1e-8) for G and for D.'''
    return tuple(torch.optim.Adam(m.parameters(), lr=args.lr, betas=(args.beta1, args.beta2),
                                  eps=1e-8) for m in (G, D))


def draw_step_inputs(G, real, generator):
    '''The step's random draws: z, and the penalty's alpha [B, 1, 1, 1].'''
    draws = dcgan.draw_step_inputs(G, real, generator)
    draws['alpha'] = sample_unoise((real.shape[0], 1, 1, 1), generator)
    return draws


def per_sample_gradient_penalty(alpha, real, fake, d_apply):
    '''E[(||grad_x D(x_hat)||_2 - 1)^2], x_hat = real * alpha + fake *
    (1 - alpha) in float32, the norm sqrt(sum g^2 + 1e-12) per sample.'''
    x_hat = (real * alpha + fake * (1.0 - alpha)).float().detach().requires_grad_(True)
    (grads,) = torch.autograd.grad(d_apply(x_hat).float().sum(), x_hat, create_graph=True)
    g = grads.reshape(grads.shape[0], -1)
    norm = torch.sqrt((g * g).sum(dim=1) + 1e-12)
    return ((norm - 1.0) ** 2).mean()


def build_steps(G, D, g_opt, d_opt, loss, gp_gamma):
    '''The two variants, `{'critic': step, 'full': step}`, each
    `step(state, real, draws=None) -> metrics`; the draws hold z and alpha.'''
    def d_apply(x):
        with buffers_dropped(D):
            return D(x)

    def d_step(state, real, draws, full):
        def penalty(real, fake):
            return per_sample_gradient_penalty(draws['alpha'], real, fake, d_apply) * gp_gamma
        d_loss = dcgan.d_phase(G, D, draws['z'], real, d_opt, loss, penalty,
                               keep_g_buffers=full)
        state['step'] += 1
        return d_loss.detach()

    return critic_steps(G, D, g_opt, loss, d_step, draw_step_inputs)


def build_training(args, device=None, seed=0):
    '''Everything one WGAN-gp training step needs, from `seed` (the
    namespace of `DCGAN/utils.py:assemble_training`, with the two
    variants).'''
    G, D = dcgan.build_models(args, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    steps = build_steps(G, D, g_opt, d_opt, WGANLoss(), args.gp_gamma)
    return dcgan.assemble_training(G, D, g_opt, d_opt, steps, critic_cadence(args.n_critic),
                                   seed)


def train(args, max_iters, loader, name='WGAN_gp'):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return dcgan.run_recipe(run, args, accel, max_iters, loader, name, num_test=25, nrow=5)


def main(parser):
    parser = add_args(parser, WGAN_GP_ARGS)
    args = parser.parse_args()
    save_args(args)

    loader = build_loader(args, 'image')
    train(args, max_iters_of(args, loader), loader)
