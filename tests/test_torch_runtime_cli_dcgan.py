'''DCGAN, GAN, WGAN and WGAN-gp through the port's CLI on the CPU, end to
end (tests/test_torch_runtime_cli.py's pattern: `python -m
animeface_tpu_torch <recipe> --synthetic-data` at 32px, batch 8, f32, in a
subprocess with tqdm, PIL, matplotlib, sklearn, JAX and the JAX package
blocked), then `--resume`: the artifacts, the grids' rows (4 a row of 16
for DCGAN and GAN, 5 a row of 25 for the WGANs), `G_<step>.pt` equal to
G's state, and WGAN's cadence: G steps where (i + 1) % n_critic == 0, also
after the resume, with g = 0 logged on the critic steps.'''

import json
import os
import struct

import numpy as np
import pytest
import torch

from test_torch_runtime_cli import run_cli


def png_size(path):
    '''(width, height) from a PNG's IHDR chunk.'''
    data = path.read_bytes()
    assert data.startswith(b'\x89PNG\r\n\x1a\n')
    return struct.unpack('>II', data[16:24])


def grid_size(n, nrow, size, pad=2):
    '''`utils/misc.py:_grid_uint8`'s (width, height) for n images.'''
    ncol = min(nrow, n)
    return ncol * (size + pad) + pad, -(-n // ncol) * (size + pad) + pad


def check_run(out, iters, save, resume_to, model_key, num_test, nrow, size=32):
    '''The artifacts of a run and its resume: args-*.json, the grids of
    `num_test` images `nrow` to a row and `G_<step>.pt` (the state of
    `model_key`) at each save and at the end of both runs, the last
    checkpoint at `resume_to` with finite losses from both runs. Returns
    the checkpoint's state and its per-step losses.'''
    files = set(os.listdir(out))
    assert any(f.startswith('args-') for f in files), files
    for step in sorted({save, iters, resume_to}):
        assert {f'{step}.png', f'G_{step}.pt'} <= files, files
        assert png_size(out / f'{step}.png') == grid_size(num_test, nrow, size)
    ckpts = sorted(os.listdir(out / 'checkpoint'), key=lambda n: int(n.split('-')[1]))
    assert ckpts[-1] == f'ckpt-{resume_to}' and len(ckpts) <= 3, ckpts
    latest = out / 'checkpoint' / ckpts[-1]
    meta = json.loads((latest / 'meta.json').read_text())
    losses = meta['status']['loss']
    assert meta['status']['batches_done'] == resume_to
    for key, values in losses.items():
        assert len(values) == resume_to and all(np.isfinite(v) for v in values), key
    state = torch.load(latest / 'state.pt', weights_only=True)
    assert state['run']['step'] == resume_to
    weights = torch.load(out / f'G_{resume_to}.pt', weights_only=True)
    assert set(weights) == set(state[model_key])
    assert all(torch.equal(v, state[model_key][k]) for k, v in weights.items())
    return state, losses


@pytest.mark.parametrize('recipe', ['DCGAN', 'GAN'])
def test_dcgan_and_gan_cli_train_and_resume(tmp_path, recipe):
    out = run_cli(tmp_path, recipe, 4, 2, 6, flags=('--latent-dim', '8'))
    state, _ = check_run(out, 4, 2, 6, 'G', num_test=16, nrow=4)
    assert set(state) == {'G', 'D', 'g_opt', 'd_opt', 'run'}
    if recipe == 'DCGAN':
        assert any(k.endswith('running_var') for k in state['D'])


@pytest.mark.parametrize('recipe', ['WGAN', 'WGAN_gp'])
def test_wgan_cli_keeps_the_critic_cadence_across_a_resume(tmp_path, recipe):
    out = run_cli(tmp_path, recipe, 7, 7, 10, flags=('--latent-dim', '8'))
    state, losses = check_run(out, 7, 7, 10, 'G', num_test=25, nrow=5)
    assert [g != 0 for g in losses['g']] == [(i + 1) % 5 == 0 for i in range(10)]
    if recipe == 'WGAN':
        assert all(float(v.abs().max()) <= 0.01 for k, v in state['D'].items()
                   if not k.endswith(('running_mean', 'running_var')))
    else:
        assert [s['step'] for s in state['d_opt']['state'].values()][0] == 10
