'''The runtime the paired recipes share (pix2pix, SRGAN, ESRGAN).

Counterpart of the tails of `main` and `train` in the JAX
`implementations/{pix2pix,SRGAN,ESRGAN}/utils.py`: the task's loader and
its test batch (the dataset's first `num_test` samples in order, one
worker), the sample grid of three columns (the condition shown as an
image, the target, G's output for the condition), and the loop:
`run_training` around a recipe's `build_training` namespace, with G's
state dict as `G_<step>.pt`.
'''

from __future__ import annotations

import numpy as np
import torch

from animeface_tpu_torch.dataset import DataLoader, build_loader
from animeface_tpu_torch.nnutils.trainer import run_training
from animeface_tpu_torch.nnutils.training import train_state


def load_task(args, task: str):
    '''The training loader of `task` (`build_loader`, which refuses files
    nothing here decodes) and the test batch: its dataset's first
    `args.num_test` samples, in order, as numpy NHWC arrays.'''
    loader = build_loader(args, task)
    test_batch = next(iter(DataLoader(loader.dataset, args.num_test, shuffle=False,
                                      num_workers=1)))
    return loader, test_batch


def nchw(batch, device):
    '''Numpy NHWC arrays (a tuple of them) as float32 NCHW tensors on `device`.'''
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(device)
                 for a in batch)


def make_grid_sampler(generate, shown, target):
    '''`sample()`: `generate()` under torch.no_grad(), interleaved with
    `shown` and `target` into the rows (shown, target, generated) of one
    NCHW batch, as the JAX grid's `make_image_grid(shown, target, gen)`.'''
    def sample():
        with torch.no_grad():
            gen = generate()
        return torch.stack([shown, target, gen.to(target.dtype)], dim=1).flatten(0, 1)
    return sample


def run_paired(name, run, args, accel, loader, max_iters, nrow):
    '''`run_training` around a `build_training` namespace: grids of
    `run.sample_fn` `nrow` a row, G's state dict as `G_<step>.pt`.'''
    def train_step(state, batch):
        return state, run.train_step(state['run'], batch)

    return run_training(
        name=name, args=args, accel=accel, state=train_state(run), loader=loader,
        train_step=train_step, sample_fn=lambda state: run.sample_fn(),
        max_iters=max_iters, save_interval=args.save, nrow=nrow,
        ema_params_path=lambda s: s['G'].state_dict(),
    )
