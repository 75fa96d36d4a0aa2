'''The PGGAN recipe in PyTorch: the phase machine, the training step, the
progressive training loop (shared with StyleGAN v1) and the CLI.

Counterpart of `animeface_tpu/implementations/PGGAN/utils.py`. Kept:
  * `Step`, the phase machine: D_stablization at 4px, then per
    resolution G_transition, G_stablization, D_transition,
    D_stablization, each `resl2num[resolution]` epochs;
  * the step: one z feeds the D and the G phase; D's loss is the
    adversarial loss plus gp_lambda times `gradient_penalty` (one alpha
    for the batch) plus drift_epsilon times mean(D(real)^2); G's loss is
    taken against the D just updated; alpha is read once and becomes
    min(1, alpha + alpha_delta); the metrics are d, g and alpha. Adam with
    betas (0.0, 0.99) and optax's eps and bias correction steps every
    parameter of G and D, a parameter off the active path with a zero
    gradient, as optax steps every leaf;
  * the loop: fresh optimizers at `resl2lr[resolution]` whenever the
    resolution changes; each epoch a new dataset at the resolution and a
    new `DataLoader(dataset, resl2batch_size[resolution], seed=args.seed)`,
    so each epoch sees the same order, as in JAX; alpha_delta =
    resl2num[resolution] / len(loader); alpha reset to 0 on a transition
    phase's first epoch unless resuming into it; `--max-iters` ignored;
  * a mid-phase checkpoint every `--save` steps (after `Status.update`,
    `phase_batch_idx` = batches done in the epoch) with the grid
    `<step>.png` of 16 fixed latents at the phase's depth, mode and alpha,
    `G_<step>.pt` and the sidecar `G_<step>.json` ({resolution, depth,
    mode, alpha}, read by `metrics/fid_trend.py`); a phase-boundary
    checkpoint after each `Step.step()`, `opt_fresh` when the resolution
    changed. `--resume` restores the machine, alpha, the Status history,
    the weights and the step's `torch.Generator`, skips `phase_batch_idx`
    batches, and restores the optimizers' moments unless `opt_fresh`;
  * at the end `loss.png`, `final.png` at `max_depth` and `G_final.pt`.
The step mutates `state` and the modules in place and returns 0-dim
tensors without a host sync; its draws (z, the penalty's alpha; StyleGAN
adds noise maps) are an input, by default drawn from `state['generator']`.
'''

from __future__ import annotations

import copy
import json
import os
from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.checkpoint import Checkpointer, save_model
from animeface_tpu_torch.dataset import DataLoader, build_dataset
from animeface_tpu_torch.implementations.PGGAN import config
from animeface_tpu_torch.implementations.PGGAN.model import (
    Discriminator, Generator, RESOLUTIONS)
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.loss import WGANLoss, gradient_penalty
from animeface_tpu_torch.nnutils.rng import make_generator, sample_nnoise, sample_unoise
from animeface_tpu_torch.nnutils.trainer import check_sustained_nan, host_images
from animeface_tpu_torch.nnutils.training import step_all_parameters
from animeface_tpu_torch.utils import Status, add_args, save_args, save_image
from animeface_tpu_torch.utils.argument import recipe_defaults, result_dir

#: the recipe's flags (with the global ones; --image-size sets the last
#: resolution, --batch-size and --max-iters are not read)
PGGAN_ARGS = dict(
    latent_dim=[100, 'input latent dimension'],
    gp_lambda=[10., 'lambda for gradient penalty'],
    drift_epsilon=[0.001, 'eps for drift'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('PGGAN', PGGAN_ARGS, overrides)


def compute_dtype(args):
    return torch.float32 if args.no_bf16 else torch.bfloat16


class Step:
    '''The phase machine (JAX `Step`).'''

    def __init__(self, max_resolution, resl2num):
        self.current_phase = 'D_stablization'
        self.current_resolution = 4
        self.max_resolution = max_resolution
        self.resl2num = resl2num
        self.skip_count = 1
        self.grow_flag = False

    def step(self) -> bool:
        if self.skip_count < self.resl2num[self.current_resolution]:
            self.skip_count += 1
            return True
        self.skip_count = 1
        if self.current_phase == 'D_stablization':
            self.current_phase = 'G_transition'
            self.current_resolution *= 2
            self.grow_flag = True
        elif self.current_phase == 'G_transition':
            self.current_phase = 'G_stablization'
        elif self.current_phase == 'G_stablization':
            self.current_phase = 'D_transition'
        elif self.current_phase == 'D_transition':
            self.current_phase = 'D_stablization'
        return self.current_resolution <= self.max_resolution

    def get_mode(self):
        return (('t' if self.current_phase == 'G_transition' else 's'),
                ('t' if self.current_phase == 'D_transition' else 's'))

    def should_grow(self):
        if self.grow_flag:
            self.grow_flag = False
            return True
        return False

    def state_dict(self) -> dict:
        return dict(current_phase=self.current_phase,
                    current_resolution=self.current_resolution,
                    skip_count=self.skip_count, grow_flag=self.grow_flag)

    def load_state_dict(self, m: dict) -> None:
        self.current_phase = m['current_phase']
        self.current_resolution = int(m['current_resolution'])
        self.skip_count = int(m['skip_count'])
        self.grow_flag = bool(m['grow_flag'])


def build_models(args, device=None, seed=0):
    '''G and D with every block up to `args.image_size` on `device`
    (default `cuda`), weights drawn from `seed`, computing in bf16 unless
    `args.no_bf16`.'''
    device = resolve_device(device)
    g = torch.Generator().manual_seed(int(seed))
    max_depth = RESOLUTIONS.index(args.image_size)
    G = Generator(args.latent_dim, max_depth, compute_dtype(args), g)
    D = Discriminator(max_depth, compute_dtype(args), g)
    return G.to(device), D.to(device)


def make_optimizers(G, D, resolution):
    '''Adam(resl2lr[resolution], betas (0.0, 0.99), eps 1e-8) for G and D.'''
    lr = config.resl2lr[resolution]
    return tuple(torch.optim.Adam(m.parameters(), lr=lr, betas=config.betas, eps=1e-8)
                 for m in (G, D))


def draw_step_inputs(G, real, generator, depth):
    '''The step's random draws: z, and the penalty's alpha [1, 1, 1, 1].'''
    return dict(z=sample_nnoise((real.shape[0], G.latent_dim), generator),
                gp_alpha=sample_unoise((1, 1, 1, 1), generator))


def build_train_step(G, D, g_opt, d_opt, loss, gp_lambda, drift_epsilon, depth, g_mode, d_mode,
                     draw=draw_step_inputs):
    '''One iteration at (depth, g_mode, d_mode). Returns `train_step(state,
    real, draws=None) -> metrics`; `state` holds 'step', 'generator',
    'alpha' and 'alpha_delta' (0-dim float32 tensors on the device).'''
    def train_step(state, real, draws=None):
        if draws is None:
            draws = draw(G, real, state['generator'], depth)
        alpha = state['alpha']
        g_kw = dict(depth=depth, mode=g_mode, alpha=alpha)
        if 'noise' in draws:
            g_kw['noise'] = draws['noise']

        def d_apply(x):
            return D(x, depth, d_mode, alpha)

        with torch.no_grad():
            fake = G(draws['z'], **g_kw)
        D.requires_grad_(True)
        d_opt.zero_grad(set_to_none=True)
        real_prob = d_apply(real)
        d_loss = (loss.d_loss(real_prob, d_apply(fake))
                  + gp_lambda * gradient_penalty(real, fake, d_apply, draws['gp_alpha'])
                  + drift_epsilon * (real_prob ** 2).mean())
        d_loss.backward()
        step_all_parameters(d_opt, D)

        D.requires_grad_(False)
        g_opt.zero_grad(set_to_none=True)
        g_loss = loss.g_loss(d_apply(G(draws['z'], **g_kw)))
        g_loss.backward()
        step_all_parameters(g_opt, G)
        D.requires_grad_(True)

        state['alpha'] = torch.clamp(alpha + state['alpha_delta'], max=1.0)
        state['step'] += 1
        return dict(d=d_loss.detach(), g=g_loss.detach(), alpha=alpha)

    return train_step


#: what the progressive loop needs of a recipe
RECIPE = SimpleNamespace(name='PGGAN', build_models=build_models, loss=WGANLoss,
                         resl2num=config.resl2num, draw=draw_step_inputs, noise_shapes=None)


def dataset_factory(args):
    '''resolution -> the run's dataset at that image size.'''
    def make(resolution):
        a = copy.copy(args)
        a.image_size = resolution
        return build_dataset(a, 'image')
    return make


def train(args, dataset_factory, recipe=RECIPE):
    '''The progressive loop (see the module docstring) for `recipe`.
    Returns (G, status).'''
    accel = Accelerator(bf16=not args.no_bf16)
    device = accel.device
    max_depth = RESOLUTIONS.index(args.image_size)
    G, D = recipe.build_models(args, device, seed=args.seed)
    loss = recipe.loss()
    out_dir = result_dir(recipe.name)
    resl2num = recipe.resl2num
    machine = Step(args.image_size, resl2num)

    total_iters = sum(len(dataset_factory(r)) // config.resl2batch_size[r] * resl2num[r]
                      * (1 if r == 4 else 4) for r in RESOLUTIONS[:max_depth + 1])
    status = Status(total_iters, bar=not args.log_file, log_file=args.log_file)

    fixed = torch.Generator().manual_seed(args.seed)
    const_z = torch.randn((16, args.latent_dim), generator=fixed).to(device)
    sample_kw = {}
    if recipe.noise_shapes is not None:
        sample_kw['noise'] = [torch.randn(s, generator=fixed).to(device)
                              for s in recipe.noise_shapes(16, max_depth)]
    run = dict(step=0, generator=make_generator(args.seed, device),
               alpha=torch.ones((), device=device), alpha_delta=torch.zeros((), device=device))

    current_resl = -1
    g_opt = d_opt = None
    skip_batches = 0   # mid-phase fast-forward after --resume
    ckpt = Checkpointer(os.path.join(out_dir, 'checkpoint'), max_to_keep=3)

    def save(phase_batch_idx, opt_fresh):
        ckpt.save(status.batches_done, dict(G=G, D=D, g_opt=g_opt, d_opt=d_opt, run=run),
                  meta={'status': status.state_dict(), 'machine': machine.state_dict(),
                        'phase_batch_idx': phase_batch_idx, 'opt_fresh': opt_fresh})

    if getattr(args, 'resume', None):
        # the optimizers' shapes do not depend on the phase (every block
        # exists from construction), so any phase's checkpoint fills them
        g_opt, d_opt = make_optimizers(G, D, 4)
        _, meta = Checkpointer(args.resume).restore(
            dict(G=G, D=D, g_opt=g_opt, d_opt=d_opt, run=run), map_location=device)
        machine.load_state_dict(meta['machine'])
        skip_batches = int(meta['phase_batch_idx'])
        # a growth-boundary checkpoint holds the previous resolution's
        # moments, which the loop replaces with fresh optimizers
        if meta['opt_fresh']:
            g_opt = d_opt = None
        else:
            current_resl = machine.current_resolution
        if meta.get('status'):
            status.load_state_dict(meta['status'])
        status.print(f'[resume] from {args.resume} @ step {status.batches_done} '
                     f'({machine.current_phase} {machine.current_resolution}px, '
                     f'+{skip_batches} batches into the phase epoch)')

    running = True
    while running:
        resl = machine.current_resolution
        depth = RESOLUTIONS.index(resl)
        g_mode, d_mode = machine.get_mode()
        if resl != current_resl:
            current_resl = resl
            g_opt, d_opt = make_optimizers(G, D, resl)

        loader = DataLoader(dataset_factory(resl), config.resl2batch_size[resl], seed=args.seed)
        run['alpha_delta'] = torch.tensor(1.0 / max(1, len(loader)) * resl2num[resl],
                                          dtype=torch.float32, device=device)
        # alpha resets once per growth, on the transition phase's first
        # epoch, and then accumulates across its epochs; a mid-phase resume
        # keeps the restored ramp
        if (machine.current_phase.endswith('transition') and machine.skip_count == 1
                and not skip_batches):
            run['alpha'] = torch.zeros((), device=device)
        step = build_train_step(G, D, g_opt, d_opt, loss, args.gp_lambda, args.drift_epsilon,
                                depth, g_mode, d_mode, recipe.draw)

        for bi, batch in enumerate(accel.iter_loader(loader)):
            if bi < skip_batches:
                continue   # the loader's order is fixed: resume lands mid-phase
            metrics = step(run, batch)
            # update first, so the checkpoint's history holds this batch
            # (phase_batch_idx = bi + 1 skips it on resume)
            status.update(**metrics)
            if status.batches_done % args.save == 0 and status.batches_done:
                done = status.batches_done
                with torch.no_grad():
                    images = G(const_z, depth, g_mode, run['alpha'], **sample_kw)
                save_image(host_images(images), os.path.join(out_dir, f'{done}.png'), nrow=4)
                save_model(os.path.join(out_dir, f'G_{done}.pt'), G.state_dict())
                # a progressive snapshot is samplable only at its geometry
                with open(os.path.join(out_dir, f'G_{done}.json'), 'w') as f:
                    json.dump(dict(resolution=resl, depth=depth, mode=g_mode,
                                   alpha=float(run['alpha'])), f)
                save(bi + 1, False)
                check_sustained_nan(status, recipe.name)
        skip_batches = 0

        running = machine.step()
        machine.should_grow()   # the optimizers follow the resolution above
        # a kill from here on resumes at the next phase's first batch
        save(0, machine.current_resolution != resl)

    status.plot_loss(os.path.join(out_dir, 'loss'))
    with torch.no_grad():
        images = G(const_z, max_depth, 's', **sample_kw)
    save_image(host_images(images), os.path.join(out_dir, 'final.png'), nrow=4)
    save_model(os.path.join(out_dir, 'G_final.pt'), G.state_dict())
    return G, status


def main(parser):
    parser = add_args(parser, PGGAN_ARGS)
    args = parser.parse_args()
    save_args(args)
    train(args, dataset_factory(args))
