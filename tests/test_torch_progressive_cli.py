'''PGGAN and StyleGAN (v1) through the port's progressive runtime on the
CPU: the phase machine against the JAX class, alpha's ramp and reset
(also across a mid-phase resume) and the sidecars on narrow models
in-process, and a SIGKILL at a checkpoint followed by `--resume` at the
modules' fixed widths, as `tests/test_implementations.py:274-330` does
for JAX.

The kill runs are `python -m animeface_tpu_torch <recipe> --synthetic-data
--image-size 8 --num-images 32 --save 3 --no-bf16 --latent-dim 16` with
ANIMEFACE_PLATFORM=cpu in subprocesses (tqdm, JAX and the JAX package
blocked), the process killing itself with SIGKILL right after it has
published the named checkpoint: 32 images (one batch an epoch, 9 and 10
steps) rather than 64, so that the file stays cheap in the suite's
parallel run; the narrow runs above resume inside an epoch. PGGAN is
killed at ckpt-1 (the 4 -> 8px growth boundary, `opt_fresh`), resumed,
killed again at ckpt-2 (inside the 8px G_transition, between its epochs)
and resumed to the end; StyleGAN is killed at ckpt-3 (inside the 8px
G_transition, after its first epoch's batch, a mid-phase snapshot) and
resumed. Each recipe's final `G_final.pt` and its whole loss history must
equal, bitwise, those of one uninterrupted run, which each recipe shares
through a module-scoped fixture; the four lanes (two uninterrupted runs,
two kill chains) run side by side, one thread each.
'''

import concurrent.futures
import json
import os
import pathlib
import shutil
import signal
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

from animeface_tpu.implementations.PGGAN import config as jconfig
from animeface_tpu.implementations.PGGAN.utils import Step as JStep
from animeface_tpu.implementations.StyleGAN import utils as jsu
from animeface_tpu_torch.implementations.PGGAN import config
from animeface_tpu_torch.implementations.PGGAN import model as pm
from animeface_tpu_torch.implementations.PGGAN import utils as pu
from animeface_tpu_torch.implementations.StyleGAN import utils as su
from animeface_tpu_torch.utils import argument
from test_torch_pggan import one_thread  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PHASES = ['D_stablization', 'G_transition', 'G_stablization', 'D_transition']


def walk(machine):
    '''Every state the machine passes through, until it ends.'''
    states = []
    running = True
    while running:
        states.append((machine.current_phase, machine.current_resolution, machine.skip_count,
                       machine.get_mode(), machine.should_grow()))
        running = machine.step()
    return states


@pytest.mark.parametrize('recipe', ['PGGAN', 'StyleGAN'])
@pytest.mark.parametrize('image_size', [8, 32])
def test_step_machine_matches_jax(recipe, image_size):
    ours, theirs = ((config.resl2num, jconfig.resl2num) if recipe == 'PGGAN'
                    else (su.resl2num, jsu.resl2num))
    assert ours == theirs
    got = walk(pu.Step(image_size, dict(ours)))
    assert got == walk(JStep(image_size, dict(theirs)))
    order = [(p, r) for p, r, *_ in got]
    order = [s for i, s in enumerate(order) if i == 0 or s != order[i - 1]]
    want = [('D_stablization', 4)] + [(p, r) for r in (8, 16, 32)[:{8: 1, 32: 3}[image_size]]
                                      for p in PHASES[1:] + PHASES[:1]]
    assert order == want


@pytest.mark.parametrize('recipe', ['PGGAN', 'StyleGAN'])
def test_build_models_refuses_a_missing_card(monkeypatch, recipe):
    module = pu if recipe == 'PGGAN' else su
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError):
        module.build_models(module.default_args(image_size=8, latent_dim=8))
    G, _ = module.build_models(module.default_args(image_size=8, latent_dim=8), 'cpu')
    assert next(G.parameters()).device == torch.device('cpu')


# --------------------------------------------- narrow models, in-process

NARROW_G = [(None, 8), (8, 8), (8, 4)]
NARROW_D = [(8, 8), (8, 8), (4, 8)]
NARROW = dict(image_size=16, num_images=128, save=37, no_bf16=True, latent_dim=8,
              synthetic_data=True)


class Killed(Exception):
    pass


@pytest.fixture
def narrow(monkeypatch, tmp_path):
    '''PGGAN's runtime on narrow models (the real classes, their width
    tables patched) at 16px, 128 images: 4 batches an epoch, so alpha_delta
    is 2/4 at 8px and 3/4 at 16px. `run(kill_at=None, resume=False)`
    trains, raising `Killed` right after ckpt-<kill_at> is published.'''
    monkeypatch.setattr(pm, 'G_PARAMS', NARROW_G)
    monkeypatch.setattr(pm, 'D_PARAMS', NARROW_D)
    monkeypatch.setenv('ANIMEFACE_PLATFORM', 'cpu')
    save = pu.Checkpointer.save

    def run(root, kill_at=None, resume=False):
        monkeypatch.setattr(argument, 'IMPLEMENTATIONS_DIR', str(root))
        ckpt = root / 'PGGAN' / 'result' / 'checkpoint'
        args = pu.default_args(**NARROW, resume=str(ckpt) if resume else None)

        def save_then_kill(self, step, state, meta=None):
            path = save(self, step, state, meta)
            if step == kill_at:
                raise Killed(step)
            return path
        monkeypatch.setattr(pu.Checkpointer, 'save', save_then_kill)
        return pu.train(args, pu.dataset_factory(args))

    return run


def want_alphas(image_size, num_images, resl2num):
    '''The alpha each step reads, from the schedule: reset to 0 on a
    transition phase's first step, + resl2num / batches after each step,
    at most 1; 1.0 before the first transition.'''
    alphas, alpha = [], 1.0
    for resl in pm.RESOLUTIONS[:pm.RESOLUTIONS.index(image_size) + 1]:
        batches = num_images // config.resl2batch_size[resl]
        delta = np.float32(resl2num[resl] / batches)
        for phase in (PHASES[:1] if resl == 4 else PHASES[1:] + PHASES[:1]):
            for epoch in range(resl2num[resl]):
                for _ in range(batches):
                    if phase.endswith('transition') and epoch == 0 and _ == 0:
                        alpha = np.float32(0.0)
                    alphas.append(float(alpha))
                    alpha = min(np.float32(1.0), np.float32(alpha + delta))
    return alphas


def test_alpha_ramp_resets_and_survives_a_mid_phase_resume(narrow, tmp_path):
    '''alpha as each step read it, against the schedule; a run killed at
    ckpt-37 (the 16px G_transition's first step, alpha 0.75 restored, not
    reset) and resumed ends with the same weights and history, bitwise.'''
    G, status = narrow(tmp_path / 'base')
    alphas = status.state_dict()['loss']['alpha']
    assert alphas == want_alphas(16, 128, config.resl2num)
    assert alphas[36:39] == [0.0, 0.75, 1.0] and alphas[4:7] == [0.0, 0.5, 1.0]
    with pytest.raises(Killed):
        narrow(tmp_path / 'kill', kill_at=37)
    meta = json.loads((tmp_path / 'kill' / 'PGGAN' / 'result' / 'checkpoint' / 'ckpt-37' /
                       'meta.json').read_text())
    assert (meta['machine']['current_phase'], meta['phase_batch_idx'], meta['opt_fresh']) == \
        ('G_transition', 1, False)
    G2, status2 = narrow(tmp_path / 'kill', resume=True)
    assert status2.state_dict()['loss'] == status.state_dict()['loss']
    assert all(torch.equal(v, G2.state_dict()[k]) for k, v in G.state_dict().items())


def test_sidecars_grids_and_final_artifacts(narrow, tmp_path):
    narrow(tmp_path)
    out = tmp_path / 'PGGAN' / 'result'
    files = set(os.listdir(out))
    assert {'37.png', 'G_37.pt', 'G_37.json', '74.png', 'G_74.pt', 'G_74.json', 'final.png',
            'G_final.pt', 'checkpoint'} <= files, files
    assert json.loads((out / 'G_37.json').read_text()) == dict(
        resolution=16, depth=2, mode='t', alpha=0.75)
    assert json.loads((out / 'G_74.json').read_text()) == dict(
        resolution=16, depth=2, mode='s', alpha=1.0)
    for name in ('37.png', 'final.png'):
        assert png_size(out / name) == (74, 74)          # 16 images, 4 a row, 16px
    G = pm.Generator(8, 2)
    G.load_state_dict(torch.load(out / 'G_final.pt', weights_only=True))
    meta = json.loads((out / 'checkpoint' / 'ckpt-84' / 'meta.json').read_text())
    assert meta['status']['batches_done'] == 84 and meta['opt_fresh'] is True


def png_size(path):
    data = pathlib.Path(path).read_bytes()
    assert data.startswith(b'\x89PNG\r\n\x1a\n')
    return struct.unpack('>II', data[16:24])


# ------------------------------------------- full width, SIGKILL and resume

RUNNER = '''
import json, os, runpy, signal, sys
for name in ('tqdm', 'jax', 'animeface_tpu'):
    sys.modules[name] = None          # any import of these now raises
kill_at = int(sys.argv[2])
if kill_at:
    from animeface_tpu_torch import checkpoint
    save = checkpoint.Checkpointer.save

    def save_then_kill(self, step, state, meta=None):
        path = save(self, step, state, meta)
        if step == kill_at:
            os.kill(os.getpid(), signal.SIGKILL)   # no atexit, no flush
        return path
    checkpoint.Checkpointer.save = save_then_kill
sys.argv = ['animeface_tpu_torch', *json.loads(sys.argv[1])]
runpy.run_module('animeface_tpu_torch', run_name='__main__', alter_sys=True)
'''
FLAGS = ['--synthetic-data', '--image-size', '8', '--num-images', '32', '--save', '3',
         '--no-bf16', '--latent-dim', '16']
KILLS = {'PGGAN': (1, 2), 'StyleGAN': (3,)}


def lane(root, recipe, kills):
    '''`recipe` killed at each of `kills` in turn and resumed, to the end;
    returns the completed processes.'''
    env = dict(os.environ, ANIMEFACE_PLATFORM='cpu', ANIMEFACE_IMPLEMENTATIONS_DIR=str(root),
               OMP_NUM_THREADS='1')
    ckpt = root / recipe / 'result' / 'checkpoint'
    runs = []
    for i, kill_at in enumerate(list(kills) + [0]):
        argv = [recipe, *FLAGS] + (['--resume', str(ckpt)] if i else [])
        runs.append(subprocess.run([sys.executable, '-c', RUNNER, json.dumps(argv),
                                    str(kill_at)], cwd=ROOT, env=env, capture_output=True,
                                   text=True, timeout=600))
    return runs


@pytest.fixture(scope='module')
def full_width(tmp_path_factory):
    '''Per recipe: the uninterrupted run's and the kill chain's result
    directories and processes.'''
    root = tmp_path_factory.mktemp('progressive')
    jobs = {(recipe, chain): (root / f'{recipe}-{chain}', recipe, KILLS[recipe] if chain else ())
            for recipe in KILLS for chain in (False, True)}
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(lane, *v) for k, v in jobs.items()}
        runs = {k: f.result() for k, f in futures.items()}
    yield {k: (jobs[k][0] / k[0] / 'result', runs[k]) for k in jobs}
    shutil.rmtree(root, ignore_errors=True)     # the lanes' checkpoints


def _last_meta(out):
    ckpt = out / 'checkpoint'
    last = max(os.listdir(ckpt), key=lambda n: int(n.split('-')[1]))
    return json.loads((ckpt / last / 'meta.json').read_text())


@pytest.mark.parametrize('recipe', ['PGGAN', 'StyleGAN'])
def test_kill_and_resume_ends_bitwise_equal(full_width, recipe):
    base_out, base = full_width[(recipe, False)]
    out, runs = full_width[(recipe, True)]
    assert base[0].returncode == 0, base[0].stderr[-4000:]
    kills = KILLS[recipe]
    for run in runs[:-1]:
        assert run.returncode == -signal.SIGKILL, run.stderr[-4000:]
    assert runs[-1].returncode == 0, runs[-1].stderr[-4000:]
    where = {('PGGAN', 1): 'G_transition 8px, +0 batches',
             ('PGGAN', 2): 'G_transition 8px, +0 batches',
             ('StyleGAN', 3): 'G_transition 8px, +1 batches'}
    for run, step in zip(runs[1:], kills):
        assert f'[resume] from {out / "checkpoint"} @ step {step} ({where[recipe, step]}' \
            in run.stdout
    want = torch.load(base_out / 'G_final.pt', weights_only=True)
    got = torch.load(out / 'G_final.pt', weights_only=True)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert _last_meta(out)['status'] == _last_meta(base_out)['status']


@pytest.mark.parametrize('recipe', ['PGGAN', 'StyleGAN'])
def test_full_width_run_artifacts(full_width, recipe):
    '''The uninterrupted run: every phase to 8px with finite losses, alpha
    as the schedule gives it, a grid, `G_<step>.pt` and its sidecar at
    each save, `final.png`, `G_final.pt` (and `loss.png` where matplotlib
    imports).'''
    out, _ = full_width[(recipe, False)]
    resl2num = config.resl2num if recipe == 'PGGAN' else su.resl2num
    loss = _last_meta(out)['status']['loss']
    steps = len(loss['alpha'])
    assert steps == (9 if recipe == 'PGGAN' else 10)
    assert loss['alpha'] == want_alphas(8, 32, resl2num)
    assert all(np.isfinite(v) for k in ('d', 'g') for v in loss[k])
    first = resl2num[4]                             # the 4px D_stablization steps
    for step in range(3, steps + 1, 3):
        in_phase = step - first - 1
        mode = 't' if 0 <= in_phase < 2 else 's'   # the 8px G_transition: 2 steps
        sidecar = json.loads((out / f'G_{step}.json').read_text())
        assert sidecar == dict(resolution=8 if step > first else 4, depth=int(step > first),
                               mode=mode, alpha=1.0), (step, sidecar)
        size = 4 * ((8 if step > first else 4) + 2) + 2     # 16 images, 4 a row
        assert png_size(out / f'{step}.png') == (size, size)
        assert (out / f'G_{step}.pt').is_file()
    files = set(os.listdir(out))
    assert {'final.png', 'G_final.pt'} <= files
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        pass
    else:
        assert 'loss.png' in files
