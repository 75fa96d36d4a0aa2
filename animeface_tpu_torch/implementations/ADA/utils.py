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

from animeface_tpu_torch.implementations.StyleGAN3 import utils as sg3
from animeface_tpu_torch.nnutils.ada import ada_init_state, make_ada_pipe

#: the ADA recipe's CLI defaults: StyleGAN3's (without DiffAugment's
#: policy) and the controller's
ADA_DEFAULTS = dict({k: v for k, v in sg3.STYLEGAN3_DEFAULTS.items() if k != 'policy'},
                    ada_interval=4, ada_target_kimg=500, ada_threshold=0.6)


def default_args(**overrides):
    '''The recipe's defaults as an argument namespace, with overrides.'''
    unknown = set(overrides) - set(ADA_DEFAULTS)
    if unknown:
        raise TypeError(f'unknown ADA arguments: {sorted(unknown)}')
    return SimpleNamespace(**dict(ADA_DEFAULTS, **overrides))


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
