'''The ADA recipe in PyTorch: the StyleGAN3 backbone with the 18-knob
AugmentPipe on D's inputs and the adaptive-p controller, and its CLI.

Counterpart of `animeface_tpu/implementations/ADA/utils.py`: the step
assembly of `train` (`build_training`: the models, optimizers and
controller state, `augment_fn` through `make_ada_pipe()`, the default ADA
knobs, at the controller's p, and the additive-R1 variant on steps where
step % gp_every == 0), `train` (StyleGAN3's `run_recipe`; the controller
is checkpointed with the step's state) and `main`.
'''

from __future__ import annotations

from animeface_tpu_torch.dataset import build_loader
from animeface_tpu_torch.implementations.StyleGAN3 import utils as sg3
from animeface_tpu_torch.nnutils.accelerate import Accelerator
from animeface_tpu_torch.nnutils.ada import ada_init_state, make_ada_pipe
from animeface_tpu_torch.nnutils.trainer import default_max_iters
from animeface_tpu_torch.utils import add_args, save_args
from animeface_tpu_torch.utils.argument import recipe_defaults

#: the recipe's flags: StyleGAN3's (without DiffAugment's policy) and the
#: controller's
ADA_ARGS = dict(
    **sg3.STYLEGAN3_ARGS,
    ada_interval=[4, 'p update interval'],
    ada_target_kimg=[500, 'target kimg for p ramp'],
    ada_threshold=[0.6, 'sign(D(real)) threshold'],
)


def default_args(**overrides):
    '''The recipe's parsed defaults as an argument namespace, with overrides.'''
    return recipe_defaults('ADA', ADA_ARGS, overrides)


def build_training(args, device=None, seed=0):
    '''Everything one ADA training step needs, from `seed`: StyleGAN3's
    `build_training` namespace (G, D, G_ema, the optimizers, `state`, the
    two variants `steps[do_r1]`, `uses_r1` and `train_step(state, real,
    draws=None) -> metrics`) with the controller in `state['ada']` and
    `pipe`, the AugmentPipe that runs at the controller's p.'''
    pipe = make_ada_pipe()

    def augment_fn(key, images, st):
        return pipe(images, st['ada']['p'], generator=key)

    run = sg3.build_training(args, device, seed, augment_fn=augment_fn, ada_enabled=True)
    run.state['ada'] = ada_init_state(args.batch_size, args.ada_interval, args.ada_target_kimg,
                                      args.ada_threshold, device=run.state['generator'].device)
    run.pipe = pipe
    return run


def train(args, max_iters, loader, name='ADA'):
    accel = Accelerator(bf16=not args.no_bf16)
    run = build_training(args, accel.device, seed=args.seed)
    return sg3.run_recipe(run, args, accel, max_iters, loader, name)


def main(parser):
    parser = add_args(parser, ADA_ARGS)
    args = parser.parse_args()
    # the reference's recipe-level `logfile` IS its Status log file
    if args.logfile and not args.log_file:
        args.log_file = args.logfile
    save_args(args)

    loader = build_loader(args, 'image')
    max_iters = default_max_iters(args, loader)
    train(args, max_iters, loader)
