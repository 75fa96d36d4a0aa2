'''TransGAN, HiT, ConvNeXt and VAN through the port's CLI on the CPU, end to
end (tests/test_torch_runtime_cli.py's runner: f32, one thread, batch 8,
tqdm, PIL, matplotlib, sklearn, JAX and the JAX package blocked), at the
widths of `tests/test_implementations.py`'s end-to-end runs of the JAX
recipes: 3 steps saving at 2, then `--resume` to 4. The four recipes run
side by side, one subprocess each (as `tests/test_torch_progressive_cli.py`
runs its lanes). Each test checks one recipe's artifacts: the sample
grids of 16 images 4 to a row, `G_<step>.pt` equal to G_ema's state, the
checkpoints with both runs' losses, the step count going on from the
checkpoint. First, each recipe's parser defaults against the JAX
recipe's `main` (`test_torch_runtime_args.recipe_parser_defaults`),
exactly.'''

import argparse
import importlib
import json
import os
import subprocess
import sys

import pytest

from animeface_tpu.utils import argument as j_argument
from animeface_tpu_torch.utils import argument as t_argument
from test_torch_runtime_args import recipe_parser_defaults
from test_torch_runtime_cli import BLOCKED, ROOT, RUNNER
from test_torch_runtime_cli_dcgan import check_run

RUNS = {
    'TransGAN': (16, ('--latent-dim', '16', '--g-embed-dim', '64', '--d-embed-dim', '64',
                      '--g-depths', '1', '1', '--bottom-width', '8', '--d-depth', '1',
                      '--patch-size', '4', '--ema', '--ttur', '--gp-every', '2')),
    'HiT': (32, ('--latent-dim', '16', '--dims', '32', '32', '16', '--bottom', '8',
                 '--low-stages', '1', '--num-heads', '4', '4', '4', '--num-blocks', '1', '1', '1',
                 '--patch-sizes', '4', '--channels', '8', '--ema', '--init-func', 'xavier',
                 '--gp-lambda', '10', '--gp-every', '2')),
    'ConvNeXt': (32, ('--latent-dim', '16', '--channels', '8', '--blocks-per-scale', '1',
                      '--d-depths', '1', '1', '1', '1', '--d-dims', '8', '16', '32', '64')),
    'VAN': (32, ('--latent-dim', '16', '--channels', '8', '--blocks-per-scale', '1',
                 '--layers', '1', '1', '1', '1')),
}
ITERS, SAVE, RESUME_TO = 3, 2, 4


@pytest.mark.parametrize('recipe', sorted(RUNS))
def test_recipe_parser_defaults_match_jax(recipe):
    '''The flags, names and defaults of `main`'s parser, and `default_args`
    (HiT's with `main`'s 128px trim of one stage).'''
    jax_module = importlib.import_module(f'animeface_tpu.implementations.{recipe}.utils')
    port_module = importlib.import_module(f'animeface_tpu_torch.implementations.{recipe}.utils')
    want = recipe_parser_defaults(j_argument, jax_module, recipe)
    assert recipe_parser_defaults(t_argument, port_module, recipe) == want
    if recipe == 'HiT':
        want = vars(jax_module.adjust_by_size(argparse.Namespace(**want)))
    assert vars(port_module.default_args()) == want


@pytest.fixture(scope='module')
def lanes(tmp_path_factory):
    '''Each recipe's run and resume in its own subprocess, all started
    together; returns {recipe: (result directory, completed process)}.'''
    root = tmp_path_factory.mktemp('simple_gan_cli')
    env = dict(os.environ, ANIMEFACE_PLATFORM='cpu', ANIMEFACE_IMPLEMENTATIONS_DIR=str(root),
               OMP_NUM_THREADS='1')
    procs = {}
    for recipe, (size, flags) in RUNS.items():
        argv = [recipe, '--synthetic-data', '--num-images', '64', '--image-size', str(size),
                '--batch-size', '8', '--max-iters', str(ITERS), '--save', str(SAVE),
                '--no-bf16', *flags]
        out = root / recipe / 'result'
        resume = argv + ['--resume', str(out / 'checkpoint'), '--max-iters', str(RESUME_TO)]
        procs[recipe] = (out, subprocess.Popen(
            [sys.executable, '-c', RUNNER, json.dumps([argv, resume]), json.dumps(BLOCKED)],
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
def test_simple_gan_cli_trains_and_resumes(lanes, recipe):
    out, rc, log = lanes[recipe]
    assert rc == 0, log[-4000:]
    assert f'[resume] from {out / "checkpoint"} @ step {ITERS}' in log
    size = RUNS[recipe][0]
    state, losses = check_run(out, ITERS, SAVE, RESUME_TO, 'G_ema', num_test=16, nrow=4,
                              size=size)
    assert set(state) == {'G', 'D', 'G_ema', 'g_opt', 'd_opt', 'run'}
    assert sorted(losses) == ['d', 'g']
    assert ('dropout_generator' in state['run']) == (recipe == 'TransGAN')
    assert not all(state['G_ema'][k].equal(v) for k, v in state['G'].items())
