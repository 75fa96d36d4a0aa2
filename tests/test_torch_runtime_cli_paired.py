'''pix2pix, SRGAN and ESRGAN through the port's CLI on the CPU, end to end
(tests/test_torch_runtime_cli.py's runner: f32, one thread, batch 8,
tqdm, PIL, matplotlib, sklearn, JAX and the JAX package blocked): 3 steps
saving at 2, then `--resume` to 4, side by side, one subprocess each.
pix2pix runs its full UNet at 32px; SRGAN and ESRGAN 16px -> 32px at
narrow widths (the VGG16 trunk on its fixed-seed random weights). Each
test checks one recipe's artifacts: the sample grids (three columns: the
condition, the target, G's output; 4 and 6 test samples), `G_<step>.pt`
equal to G's state, the checkpoints with both runs' losses, the step
count going on from the checkpoint. First, each recipe's parser defaults
against the JAX recipe's `main`, exactly.'''

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

SR_D = ('--d-channels', '4', '--num-layers', '2')
#: (flags, test samples, images a grid row)
RUNS = {
    'pix2pix': ((), 4, 6),
    'SRGAN': (('--g-channels', '8', '--num-blocks', '1', *SR_D), 6, 9),
    'ESRGAN': (('--g-channels', '8', '--hidden-channels', '4', '--num-blocks', '1',
                '--num-rd', '1', '--num-conv', '3', *SR_D), 6, 9),
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
    '''Each recipe's run and resume in its own subprocess, all started
    together; returns {recipe: (result directory, return code, log)}.'''
    root = tmp_path_factory.mktemp('paired_cli')
    env = dict(os.environ, ANIMEFACE_PLATFORM='cpu', ANIMEFACE_IMPLEMENTATIONS_DIR=str(root),
               OMP_NUM_THREADS='1')
    env.pop('ANIMEFACE_VGG_WEIGHTS', None)
    procs = {}
    for recipe, (flags, _, _) in RUNS.items():
        argv = [recipe, '--synthetic-data', '--num-images', '64', '--image-size', '32',
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
def test_paired_cli_trains_and_resumes(lanes, recipe):
    out, rc, log = lanes[recipe]
    assert rc == 0, log[-4000:]
    assert f'[resume] from {out / "checkpoint"} @ step {ITERS}' in log
    _, num_test, nrow = RUNS[recipe]
    state, losses = check_run(out, ITERS, SAVE, RESUME_TO, 'G', num_test=3 * num_test,
                              nrow=nrow)
    assert set(state) == {'G', 'D', 'g_opt', 'd_opt', 'run'}
    assert sorted(losses) == (['d', 'g'] if recipe == 'pix2pix' else ['D', 'G'])
    if recipe != 'pix2pix':
        assert any(k.endswith('.u') for k in state['D']) and any(
            k.endswith('.u') for k in state['G'])
