'''NAFNet, Restormer, pix2pixHD and CycleGAN through the port's CLI on the
CPU, end to end (tests/test_torch_runtime_cli.py's runner: f32, one thread,
batch 8, 32px, narrow widths, tqdm, PIL, matplotlib, sklearn, JAX and the
JAX package blocked), one subprocess each, side by side: 3 steps saving at
2, then `--resume` to 4. pix2pixHD runs its two invocations first: the
global one (16px, 3 steps) writes `global_final.pt`, the local one loads
it, trains 3 steps crossing `fine_from` (one epoch of two steps: 16 images)
and resumes to 4. Each test checks one recipe's artifacts: the sample
grids (NAFNet's, Restormer's and pix2pixHD's three columns of 4 test
samples, 6 a row; CycleGAN's two of 6, 4 a row), `G_<step>.pt` equal to
G's state, the checkpoints with both runs' losses, the step count going
on from the checkpoint; pix2pixHD's global G kept exactly through the
local pre-steps and moved by the fine ones. First, each recipe's parser
defaults against the JAX recipe's `main`, exactly.'''

import importlib
import json
import os
import subprocess
import sys

import pytest
import torch

from animeface_tpu.utils import argument as j_argument
from animeface_tpu_torch.utils import argument as t_argument
from test_torch_runtime_args import recipe_parser_defaults
from test_torch_runtime_cli import BLOCKED, ROOT, RUNNER
from test_torch_runtime_cli_dcgan import check_run

#: (flags, images in a grid, images a row)
RUNS = {
    'NAFNet': (('--g-channels', '8', '--blocks-per-scale', '1', '--mid-blocks', '1',
                '--d-channels', '8'), 12, 6),
    'Restormer': (('--g-channels', '8', '--num-blocks', '1', '1', '--num-heads', '1', '2',
                   '--num-refinement-blocks', '1', '--d-channels', '8'), 12, 6),
    'pix2pixHD': (('--channels', '4', '--global-num-downs', '1', '--global-num-blocks', '1',
                   '--local-num-blocks', '1', '--fine-from', '1', '--num-images', '16'), 12, 6),
    'CycleGAN': (('--channels', '4', '--num-blocks', '1', '--downsample-to', '16'), 12, 4),
}
ITERS, SAVE, RESUME_TO = 3, 2, 4


@pytest.mark.parametrize('recipe', sorted(RUNS))
def test_recipe_parser_defaults_match_jax(recipe):
    jax_module = importlib.import_module(f'animeface_tpu.implementations.{recipe}.utils')
    port_module = importlib.import_module(f'animeface_tpu_torch.implementations.{recipe}.utils')
    want = recipe_parser_defaults(j_argument, jax_module, recipe)
    assert recipe_parser_defaults(t_argument, port_module, recipe) == want
    assert vars(port_module.default_args()) == want


@pytest.fixture(scope='module')
def lanes(tmp_path_factory):
    '''Each recipe's runs in its own subprocess, all started together;
    returns {recipe: (result directory, return code, log)}.'''
    root = tmp_path_factory.mktemp('restoration_cli')
    env = dict(os.environ, ANIMEFACE_PLATFORM='cpu', ANIMEFACE_IMPLEMENTATIONS_DIR=str(root),
               OMP_NUM_THREADS='1')
    procs = {}
    for recipe, (flags, _, _) in RUNS.items():
        argv = [recipe, '--synthetic-data', '--num-images', '64', '--image-size', '32',
                '--batch-size', '8', '--max-iters', str(ITERS), '--save', str(SAVE),
                '--no-bf16', *flags]
        out = root / recipe / 'result'
        resume = argv + ['--resume', str(out / 'checkpoint'), '--max-iters', str(RESUME_TO)]
        runs = [argv, argv, resume] if recipe == 'pix2pixHD' else [argv, resume]
        procs[recipe] = (out, subprocess.Popen(
            [sys.executable, '-c', RUNNER, json.dumps(runs), json.dumps(BLOCKED)],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    done = {}
    try:
        for recipe, (out, proc) in procs.items():
            stdout, stderr = proc.communicate(timeout=300)
            done[recipe] = (out, proc.returncode, stdout + stderr)
    finally:
        for _, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
    return done


@pytest.mark.parametrize('recipe', sorted(RUNS))
def test_restoration_cli_trains_and_resumes(lanes, recipe):
    out, rc, log = lanes[recipe]
    assert rc == 0, log[-4000:]
    assert f'[resume] from {out / "checkpoint"} @ step {ITERS}' in log
    _, images, nrow = RUNS[recipe]
    state, losses = check_run(out, ITERS, SAVE, RESUME_TO, 'G', num_test=images, nrow=nrow)
    assert set(state) == {'G', 'D', 'g_opt', 'd_opt', 'run'}
    assert sorted(losses) == (['D', 'G'] if recipe in ('NAFNet', 'Restormer') else ['d', 'g'])
    if recipe == 'NAFNet':
        assert any(k.endswith('running_var') for k in state['D'])
    if recipe == 'CycleGAN':
        assert {k.split('.')[0] for k in state['G']} == {'G_ab', 'G_ba'}
        assert any(k.endswith('.u') for k in state['G']) and any(
            k.endswith('.u') for k in state['D'])
    if recipe == 'pix2pixHD':
        assert 'global phase done' in log
        glob = torch.load(out / 'global_final.pt', weights_only=True)
        assert set(glob) == {'G', 'D'}
        for step, kept in ((SAVE, True), (ITERS, False)):
            weights = torch.load(out / f'G_{step}.pt', weights_only=True)
            same = all(torch.equal(v, glob['G'][k]) for k, v in weights.items()
                       if k.startswith('global_g.'))
            assert same == kept, f'G_{step}.pt: global G kept {same}, want {kept}'
