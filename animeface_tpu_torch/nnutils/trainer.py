'''Shared host-side training loop.

Counterpart of `animeface_tpu/nnutils/trainer.py`: the recipe owns the
step, `run_training` the choreography around it, with the JAX cadence:
`Status.update` after each step and before the save branch; a snapshot
(checks, sample grid, `running.jpg`, the EMA weights `G_<step>.pt`, a
full-state checkpoint) when `batches_done % save_interval == 0`; sample
grids alone at `sample_interval` if it is set; the sustained-NaN guard
every `max(log_interval, 10)` steps; a last snapshot and the loss plot at
the end. `--resume` restores the latest checkpoint of the directory it
names into the built state; the loader starts again at epoch 0, as in JAX.

The state is the training state of `checkpoint.py` (modules, optimizers,
the step's dict); `train_step(state, batch) -> (state, metrics)` takes
NCHW batches on the device and returns 0-dim tensors, read only when shown.
'''

from __future__ import annotations

import math
import os
from typing import Callable

import numpy as np
import torch

from animeface_tpu_torch.checkpoint import Checkpointer, save_model, snapshot, tensors
from animeface_tpu_torch.utils import Status, save_image
from animeface_tpu_torch.utils.argument import result_dir


def check_sustained_nan(status, name: str, window: int = 10) -> None:
    '''Raise when ANY loss series with at least `window` values has been
    non-finite for its last `window` steps. "Any" (not "all") because
    always-finite metrics, such as ADA's clamped p, would otherwise veto the
    guard while the losses are NaN.'''
    for key, tail in status.loss_tail(window).items():
        if len(tail) < window:
            continue
        if not any(math.isfinite(v) for v in tail):
            raise FloatingPointError(
                f'[{name}] loss series {key!r} non-finite for {window} '
                f'consecutive steps at iter {status.batches_done}; aborting '
                f'(resume from the last checkpoint with --resume)')


def host_step_counter():
    '''Host-side iteration index for the cadence of a recipe's variants
    (lazy regularization, R1 every N). The first call reads
    `state['step']`, so after `--resume` the cadence continues from the
    restored step instead of restarting at 0.

    Returns `next_index(state) -> int`: the current index, then advances.
    '''
    box = {'i': None}

    def next_index(state) -> int:
        if box['i'] is None:
            box['i'] = int(state['step']) if 'step' in state else 0
        i = box['i']
        box['i'] += 1
        return i

    return next_index


def default_max_iters(args, loader) -> int:
    '''max_iters < 0 -> epochs * len(loader).'''
    if args.max_iters is not None and args.max_iters >= 0:
        return args.max_iters
    return len(loader) * args.default_epochs


def host_images(images) -> np.ndarray:
    '''A sample batch (NCHW tensor) as the NHWC float32 array `save_image` takes.'''
    return images.detach().float().permute(0, 2, 3, 1).cpu().numpy()


def run_training(
    name: str,
    args,
    accel,
    state,
    loader,
    train_step: Callable,          # (state, batch) -> (state, {metrics})
    sample_fn: Callable | None,    # (state) -> NCHW images for the grid
    max_iters: int,
    save_interval: int,
    ema_params_path: Callable | None = None,  # state -> the state dict of G_<step>.pt
    status: Status | None = None,
    checkpoint_keep: int = 3,
    nrow: int = 4,
    sample_interval: int | None = None,       # sample cadence if != save
):
    out_dir = result_dir(name)
    if status is None:
        status = Status(max_iters, bar=not getattr(args, 'log_file', None),
                        log_file=getattr(args, 'log_file', None),
                        log_interval=getattr(args, 'log_interval', 1))
    ckpt = Checkpointer(os.path.join(out_dir, 'checkpoint'), max_to_keep=checkpoint_keep)

    # ---- resume ----
    resume_dir = getattr(args, 'resume', None)
    if resume_dir:
        _, meta = Checkpointer(resume_dir).restore(state, map_location=accel.device)
        if meta.get('status'):
            status.load_state_dict(meta['status'])
        status.print(f'[resume] from {resume_dir} @ step {status.batches_done}')

    sample_interval_ = sample_interval or save_interval

    def save_snapshot(state, do_sample=True):
        step = status.batches_done
        # One device holds the state, so the JAX replica-drift check has no
        # counterpart until multi-GPU (ROADMAP Queue 1 item 9).
        # Recipes that sanitize logged losses can still diverge silently:
        # probe one floating tensor of each state entry.
        for key_name, sub in state.items():
            probe = next((t for t in tensors(snapshot(sub)) if t.is_floating_point()), None)
            if probe is not None and not bool(torch.isfinite(probe).all()):
                raise FloatingPointError(f'[{name}] non-finite values in state[{key_name!r}] '
                                         f'at iter {step}; aborting')
        if sample_fn is not None and do_sample:
            images = host_images(sample_fn(state))
            save_image(images, os.path.join(out_dir, f'{step}.png'), nrow=nrow)
            save_image(images, os.path.join(out_dir, 'running.jpg'), nrow=nrow)
        if ema_params_path is not None:
            save_model(os.path.join(out_dir, f'G_{step}.pt'), ema_params_path(state))
        ckpt.save(step, state, meta={'status': status.state_dict(),
                                     'args': {k: str(v) for k, v in vars(args).items()}})

    # ---- loop ----
    if len(loader) == 0:
        raise ValueError(
            f'[{name}] empty loader: the dataset has fewer samples than one '
            f'batch (dataset filters like --min-year can cause this)')
    # abort on losses non-finite for a sustained stretch, checked on the
    # logging cadence so the host reads the losses only then
    guard_every = max(int(getattr(args, 'log_interval', 1) or 1), 10)

    done = False
    while not done:
        for batch in accel.iter_loader(loader):
            state, metrics = train_step(state, batch)
            # Update BEFORE the cadence branches, so the snapshot's Status
            # history includes the checkpointed batch and the save branch
            # cannot fire again at the same batches_done after a resume.
            status.update(**metrics)
            if status.batches_done % save_interval == 0 and status.batches_done > 0:
                save_snapshot(state, do_sample=(
                    sample_interval is None
                    or status.batches_done % sample_interval_ == 0))
            elif sample_interval is not None and status.batches_done > 0 \
                    and status.batches_done % sample_interval_ == 0 \
                    and sample_fn is not None:
                save_image(host_images(sample_fn(state)),
                           os.path.join(out_dir, f'{status.batches_done}.png'), nrow=nrow)
            if status.batches_done % guard_every == 0:
                check_sustained_nan(status, name)
            if status.batches_done >= max_iters:
                done = True
                break

    save_snapshot(state)
    status.plot_loss(os.path.join(out_dir, 'loss'))
    return state, status
