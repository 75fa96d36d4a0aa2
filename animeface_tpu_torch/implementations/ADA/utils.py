'''The ADA recipe's training step in PyTorch: the StyleGAN3 backbone with the
18-knob AugmentPipe on D's inputs and the adaptive-p controller.

Counterpart of the step assembly in `animeface_tpu/implementations/ADA/
utils.py:train` (its lines 25-55): the models, optimizers and controller
state, `augment_fn` through `make_ada_pipe()` (the default ADA knobs) at
the controller's p, and the choice of the additive-R1 variant on steps
where step % gp_every == 0 (the others take the plain variant). The CLI,
checkpoints, the data loader and `run_training` are not ported yet.
'''

from __future__ import annotations

from types import SimpleNamespace

import torch

from animeface_tpu_torch import resolve_device
from animeface_tpu_torch.implementations.StyleGAN3.utils import (
    STYLEGAN3_DEFAULTS, build_models, build_train_step, init_state, make_optimizers)
from animeface_tpu_torch.nnutils.ada import ada_init_state, make_ada_pipe
from animeface_tpu_torch.nnutils.loss import NonSaturatingLoss

#: the ADA recipe's CLI defaults: StyleGAN3's and the controller's
ADA_DEFAULTS = dict(STYLEGAN3_DEFAULTS, ada_interval=4, ada_target_kimg=500,
                    ada_threshold=0.6)


def default_args(**overrides):
    '''The recipe's defaults as an argument namespace, with overrides.'''
    unknown = set(overrides) - set(ADA_DEFAULTS)
    if unknown:
        raise TypeError(f'unknown ADA arguments: {sorted(unknown)}')
    return SimpleNamespace(**dict(ADA_DEFAULTS, **overrides))


def build_training(args, device=None, seed=0):
    '''Everything one ADA training step needs, from `seed`: returns a
    namespace with G, D, G_ema, the optimizers, `state` (step count,
    generator, controller), `pipe`, the two variants `steps[do_r1]` and
    `train_step(state, real, draws=None) -> metrics`, which picks one.'''
    device = resolve_device(device)
    compute_dtype = torch.float32 if args.no_bf16 else torch.bfloat16
    G, D, G_ema = build_models(args, compute_dtype, device, seed)
    g_opt, d_opt = make_optimizers(args, G, D)
    state = init_state(device, seed)
    state['ada'] = ada_init_state(args.batch_size, args.ada_interval, args.ada_target_kimg,
                                  args.ada_threshold, device=device)
    pipe = make_ada_pipe()

    def augment_fn(key, images, st):
        return pipe(images, st['ada']['p'], generator=key)

    loss = NonSaturatingLoss()
    steps = {do_r1: build_train_step(G, D, G_ema, g_opt, d_opt, loss, args.gp_lambda, do_r1,
                                     augment_fn, ada_enabled=True)
             for do_r1 in (False, True)}

    def uses_r1(i):
        return args.gp_lambda > 0 and i % args.gp_every == 0

    def train_step(st, real, draws=None):
        return steps[uses_r1(st['step'])](st, real, draws)

    return SimpleNamespace(G=G, D=D, G_ema=G_ema, g_opt=g_opt, d_opt=d_opt, state=state,
                           pipe=pipe, steps=steps, uses_r1=uses_r1, train_step=train_step)
