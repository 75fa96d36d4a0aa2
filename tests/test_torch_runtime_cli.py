'''The StyleGAN2 recipe through the port's CLI on the CPU, end to end:
`ANIMEFACE_PLATFORM=cpu python -m animeface_tpu_torch StyleGAN2
--synthetic-data` for 18 steps at the widths of
tests/test_implementations.py (both lazy-regularization branches run),
then `--resume` to 20, in a subprocess with tqdm, PIL, matplotlib,
sklearn, JAX and the JAX package blocked. `run_cli` and `check_artifacts`
serve the StyleGAN3 and ADA files too.'''

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ('tqdm', 'PIL', 'matplotlib', 'sklearn', 'jax', 'animeface_tpu')
RUNNER = '''
import json, runpy, sys
for name in json.loads(sys.argv[2]):
    sys.modules[name] = None          # any import of these now raises
for argv in json.loads(sys.argv[1]):
    sys.argv = ['animeface_tpu_torch', *argv]
    runpy.run_module('animeface_tpu_torch', run_name='__main__', alter_sys=True)
'''
SG3_FLAGS = ('--num-layers', '4', '--channels', '8', '--max-channels', '32', '--style-dim', '32',
             '--latent-dim', '32', '--d-channels', '8', '--d-max-channels', '32',
             '--gp-every', '2')


def run_cli(tmp_path, name, iters, save, resume_to, flags=(), image_size=32, batch=8,
            blocked=BLOCKED):
    '''`name` for `iters` steps, then `--resume` to `resume_to`, in one
    subprocess, f32 on the CPU, with the modules `blocked` unimportable.
    Returns its result directory.'''
    argv = [name, '--synthetic-data', '--num-images', '64', '--image-size', str(image_size),
            '--batch-size', str(batch), '--max-iters', str(iters), '--save', str(save),
            '--no-bf16', *flags]
    out = tmp_path / name / 'result'
    resume = argv + ['--resume', str(out / 'checkpoint'), '--max-iters', str(resume_to)]
    # one thread: the suite runs in parallel workers, and a subprocess that
    # spins its full thread pool among them slows down many times over
    env = dict(os.environ, ANIMEFACE_PLATFORM='cpu', ANIMEFACE_IMPLEMENTATIONS_DIR=str(tmp_path),
               OMP_NUM_THREADS='1')
    proc = subprocess.run([sys.executable, '-c', RUNNER, json.dumps([argv, resume]),
                           json.dumps(blocked)], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert f'[resume] from {out / "checkpoint"} @ step {iters}' in proc.stdout + proc.stderr
    for what in {'tqdm', 'PIL', 'matplotlib'} & set(blocked):
        assert what in proc.stderr          # one warning each: no bar, no running.jpg, no plot
    return out


def check_artifacts(out, iters, save, resume_to):
    '''args-*.json, the sample grids and EMA weights at each save and at the
    end of both runs, the checkpoints with finite losses; after the resume
    the Status history and the step go on to `resume_to`.'''
    files = set(os.listdir(out))
    assert sum(f.startswith('args-') for f in files) >= 1, files
    for step in sorted({save, iters, resume_to}):
        assert {f'{step}.png', f'G_{step}.pt'} <= files, files
    assert not {'running.jpg', 'loss.png'} & files, files
    ckpts = sorted(os.listdir(out / 'checkpoint'), key=lambda n: int(n.split('-')[1]))
    assert ckpts[-1] == f'ckpt-{resume_to}' and len(ckpts) <= 3, ckpts
    latest = out / 'checkpoint' / ckpts[-1]
    meta = json.loads((latest / 'meta.json').read_text())
    assert meta['status']['batches_done'] == resume_to
    for key, values in meta['status']['loss'].items():
        assert len(values) == resume_to and all(np.isfinite(v) for v in values), key
    state = torch.load(latest / 'state.pt', weights_only=True)
    assert state['run']['step'] == resume_to
    assert {'G', 'D', 'G_ema', 'g_opt', 'd_opt', 'run'} == set(state)
    grid = (out / f'{resume_to}.png').read_bytes()
    assert grid.startswith(b'\x89PNG\r\n\x1a\n')
    G_ema = torch.load(out / f'G_{resume_to}.pt', weights_only=True)
    assert all(torch.equal(v, state['G_ema'][k]) for k, v in G_ema.items())
    return state


def test_stylegan2_cli_trains_and_resumes(tmp_path):
    out = run_cli(tmp_path, 'StyleGAN2', 18, 9, 20,
                  flags=('--pl-lambda', '2.0', '--d-k', '16', '--g-k', '8', '--channels', '8',
                         '--max-channels', '64', '--style-dim', '32', '--map-num-layers', '2'))
    state = check_artifacts(out, 18, 9, 20)
    assert float(state['run']['pl_mean']) > 0          # path length ran at steps 8 and 16
