'''The runtime the paired recipes share (pix2pix, SRGAN, ESRGAN, NAFNet,
Restormer, pix2pixHD, CycleGAN).

Counterpart of the tails of `main` and `train` in the JAX
`implementations/{pix2pix,SRGAN,ESRGAN,NAFNet,pix2pixHD,CycleGAN}/utils.py`:
the task's loader and its test batch (the dataset's first `num_test`
samples in order, one worker), the sample grid (G's output for the test
batch interleaved with given columns, as the JAX `make_image_grid`), and
the loop: `run_training` around a recipe's `build_training` namespace,
with G's state dict as `G_<step>.pt`.
'''

from __future__ import annotations

import numpy as np
import torch

from animeface_tpu_torch.dataset import DataLoader, build_loader
from animeface_tpu_torch.nnutils.trainer import run_training
from animeface_tpu_torch.nnutils.training import train_state


def load_task(args, task: str, num_test: int | None = None):
    '''The training loader of `task` (`build_loader`, which refuses files
    nothing here decodes) and the test batch: its dataset's first
    `num_test` (default `args.num_test`) samples, in order, as numpy NHWC
    arrays.'''
    loader = build_loader(args, task)
    test_batch = next(iter(DataLoader(loader.dataset, num_test or args.num_test, shuffle=False,
                                      num_workers=1)))
    return loader, test_batch


def nchw(batch, device):
    '''Numpy NHWC arrays (a tuple of them) as float32 NCHW tensors on `device`.'''
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).permute(0, 3, 1, 2).to(device)
                 for a in batch)


def as_rgb(images):
    '''NCHW images with three channels: a single channel repeated.'''
    return images.expand(-1, 3, -1, -1) if images.shape[1] == 1 else images


def make_grid_sampler(generate, before, after=()):
    '''`sample()`: `generate()` under torch.no_grad(), interleaved with the
    NCHW batches `before` and `after` into the images (*before, generated,
    *after) of each test sample in turn, one NCHW batch, as the JAX grid's
    `make_image_grid(*before, gen, *after)`.'''
    def sample():
        with torch.no_grad():
            gen = generate()
        cols = [*before, gen.to(before[0].dtype), *after]
        return torch.stack(cols, dim=1).flatten(0, 1)
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
