'''normalizations, SPADE and SCFT through the port's CLI on the CPU, end to
end (tests/test_torch_runtime_cli.py's runner: f32, one thread, batch 8
(SCFT's 2), narrow widths, tqdm, PIL, matplotlib, sklearn, JAX and the JAX package
blocked), one subprocess each, side by side: 3 steps saving at 2, then
`--resume` to 4, each at the smallest size its D takes (normalizations
32px, SPADE 64px for its second D scale, SCFT 128px for its VALID D).
Each test checks one recipe's artifacts: the sample grids (three columns
of the test samples, 6 a row), `G_<step>.pt` equal to G's state (SPADE's
with its encoder), the checkpoints with both runs' losses, the step count
going on from the checkpoint. First, each recipe's parser defaults
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

#: (size, flags, images in a grid)
RUNS = {
    'normalizations': (32, ('--channels', '4', '--style-dim', '8', '--d-channels', '4',
                            '--norm-name', 'polin'), 12),
    'SPADE': (64, ('--channels', '2', '--z-dim', '8', '--max-channels', '16',
                   '--spade-hidden-channels', '4', '--ttur'), 18),
    'SCFT': (128, ('--enc-channels', '2', '--num-res-blocks', '1', '--d-channels', '4',
                   '--batch-size', '2'), 27),
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
    root = tmp_path_factory.mktemp('xdog_cli')
    env = dict(os.environ, ANIMEFACE_PLATFORM='cpu', ANIMEFACE_IMPLEMENTATIONS_DIR=str(root),
               OMP_NUM_THREADS='1')
    procs = {}
    for recipe, (size, flags, _) in RUNS.items():
        argv = [recipe, '--synthetic-data', '--num-images', '32', '--image-size', str(size),
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
def test_xdog_cli_trains_and_resumes(lanes, recipe):
    out, rc, log = lanes[recipe]
    assert rc == 0, log[-4000:]
    assert f'[resume] from {out / "checkpoint"} @ step {ITERS}' in log
    size, _, images = RUNS[recipe]
    state, losses = check_run(out, ITERS, SAVE, RESUME_TO, 'G', num_test=images, nrow=6,
                              size=size)
    assert set(state) == {'G', 'D', 'g_opt', 'd_opt', 'run'}
    assert sorted(losses) == (['D', 'G'] if recipe == 'normalizations' else ['d', 'g'])
    if recipe == 'SPADE':
        assert {k.split('.')[0] for k in state['G']} == {'G', 'E'}
    if recipe != 'normalizations':
        assert any(k.endswith('.u') for k in state['G']) and any(
            k.endswith('.u') for k in state['D'])
