'''The port's training loop against the JAX package's, the whole slice
with recording stand-ins for the steps: `run_training` with a stub
`train_step` on the same synthetic data and arguments (save and sample
cadences, then a resume) gives the same step indices, the same batches
(after NHWC -> NCHW), the same files in the result directory (`.msgpack`
-> `.pt`) and the same Status history; a NaN stub trips the guard at the
same step; and the StyleGAN2, StyleGAN3 and ADA recipes' `train`, with
their step builders replaced by recorders (and on the JAX side stand-in
models), pick the same variant at every step across a resume and write
the same files.'''

import inspect
import os
import warnings

import flax.linen as nn
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from animeface_tpu.dataset._base import DataLoader as JLoader
from animeface_tpu.dataset.synthetic import SyntheticImage as JSynthetic
from animeface_tpu.nnutils import accelerate as j_accelerate
from animeface_tpu.nnutils import trainer as j_trainer
from animeface_tpu.utils import EasyDict, Status as JStatus, argument as j_argument
import animeface_tpu.dataset as j_dataset
from animeface_tpu.implementations.ADA import utils as j_ada
from animeface_tpu.implementations.StyleGAN2 import utils as j_sg2
from animeface_tpu.implementations.StyleGAN3 import utils as j_sg3

from animeface_tpu_torch.dataset._base import DataLoader as TLoader
from animeface_tpu_torch.dataset.synthetic import SyntheticImage as TSynthetic
from animeface_tpu_torch.nnutils.accelerate import Accelerator as TAccelerator
from animeface_tpu_torch.nnutils import trainer as t_trainer
from animeface_tpu_torch.utils import Status as TStatus, argument as t_argument
import animeface_tpu_torch.dataset as t_dataset
from animeface_tpu_torch.implementations.ADA import utils as t_ada
from animeface_tpu_torch.implementations.StyleGAN2 import utils as t_sg2
from animeface_tpu_torch.implementations.StyleGAN3 import utils as t_sg3


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among
    which a full thread pool per process spins many times slower.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def dirs(tmp_path, monkeypatch):
    monkeypatch.setattr(j_argument, 'IMPLEMENTATIONS_DIR', str(tmp_path / 'jax'))
    monkeypatch.setattr(t_argument, 'IMPLEMENTATIONS_DIR', str(tmp_path / 'torch'))
    return tmp_path


def _tree(root):
    '''Every file under `root`, relative, with the JAX suffix .msgpack as .pt
    and the save time stamp of args-*.json dropped.'''
    out = set()
    for d, _, files in os.walk(root):
        for f in files:
            rel = os.path.relpath(os.path.join(d, f), root).replace('.msgpack', '.pt')
            out.add('args-*.json' if os.path.basename(rel).startswith('args-') else rel)
    return out


def _checksum(batch):
    return float(np.asarray(batch, np.float64).sum()), np.asarray(batch, np.float64)[:, 0, 1, 2]


def _run_both(dirs, max_iters, resume=None, save=3, sample_interval=2, bad=None):
    '''`run_training` of both packages on the same data with stubs that
    record (step index, batch checksums); `bad` makes the loss NaN from
    that step on.'''
    args = EasyDict(log_interval=1, log_file=None, resume=None)
    out = {}
    for side in ('jax', 'torch'):
        rec = []
        if side == 'jax':
            loader = JLoader(JSynthetic(8, 40, 2), 8, seed=9)
            accel = j_accelerate.Accelerator(mesh_shape=(1,), bf16=False)
            state = {'w': jnp.zeros((2, 2)), 'step': jnp.int32(0)}

            def step(state, batch, rec=rec):
                i = int(state['step'])
                rec.append((i,) + _checksum(batch))
                d = float('nan') if bad is not None and i >= bad else 0.5 * i
                return dict(state, step=state['step'] + 1), {'d': jnp.float32(d),
                                                             'g': jnp.float32(i)}

            def sample(state):
                return jnp.full((4, 6, 6, 3), 0.1) * state['step'].astype(jnp.float32)
            run, status = j_trainer.run_training, JStatus(max_iters, bar=False)
        else:
            loader = TLoader(TSynthetic(8, 40, 2), 8, seed=9)
            accel = TAccelerator('cpu', bf16=False)
            state = {'w': torch.zeros(2, 2), 'step': 0}

            def step(state, batch, rec=rec):
                i = state['step']
                rec.append((i,) + _checksum(batch.permute(0, 2, 3, 1)))
                state['step'] += 1
                d = float('nan') if bad is not None and i >= bad else 0.5 * i
                return state, {'d': torch.tensor(d), 'g': torch.tensor(float(i))}

            def sample(state):
                return torch.full((4, 3, 6, 6), 0.1) * state['step']
            run, status = t_trainer.run_training, TStatus(max_iters, bar=False)
        a = EasyDict(args, resume=None if resume is None else
                     os.path.join(dirs, side, 'stub', 'result', 'checkpoint'))
        try:
            run(name='stub', args=a, accel=accel, state=state, loader=loader,
                train_step=step, sample_fn=sample, max_iters=max_iters, save_interval=save,
                ema_params_path=lambda s: {'w': s['w']}, status=status,
                sample_interval=sample_interval)
            error = None
        except FloatingPointError as e:
            error = str(e)
        out[side] = (rec, status, error)
    return out


def _assert_same(out, dirs):
    (jr, js, je), (tr, ts, te) = out['jax'], out['torch']
    assert [r[0] for r in jr] == [r[0] for r in tr]
    for a, b in zip(jr, tr):
        assert a[1] == b[1]
        np.testing.assert_array_equal(a[2], b[2])
    assert (je is None) == (te is None)
    assert js.batches_done == ts.batches_done
    jsd, tsd = js.state_dict(), ts.state_dict()
    assert jsd['batches_done'] == tsd['batches_done']
    assert {k: len(v) for k, v in jsd['loss'].items()} == \
        {k: len(v) for k, v in tsd['loss'].items()}
    assert _tree(dirs / 'jax') == _tree(dirs / 'torch')


def test_run_training_matches_jax_across_a_resume(dirs):
    out = _run_both(dirs, 7)
    _assert_same(out, dirs)
    assert [r[0] for r in out['torch'][0]] == list(range(7))
    files = _tree(dirs / 'torch')
    assert {'stub/result/2.png', 'stub/result/4.png', 'stub/result/6.png',
            'stub/result/7.png', 'stub/result/G_3.pt', 'stub/result/G_7.pt',
            'stub/result/loss.png', 'stub/result/checkpoint/ckpt-7/state.pt'} <= files
    assert 'stub/result/3.png' not in files        # the save at 3 is off the sample cadence
    out = _run_both(dirs, 11, resume=True)
    _assert_same(out, dirs)
    # the restored step; the loader starts again at epoch 0, as in JAX
    assert [r[0] for r in out['torch'][0]] == list(range(7, 11))
    assert out['torch'][1].batches_done == 11


def test_nan_guard_trips_at_the_same_step(dirs):
    out = _run_both(dirs, 40, save=100, bad=3)
    _assert_same(out, dirs)
    assert 'non-finite for 10' in out['torch'][2]
    assert out['torch'][1].batches_done == out['jax'][1].batches_done == 20


# ------------------------------------------------------- the recipes' cadence

SG2 = ['--pl-lambda', '2.0', '--d-k', '4', '--g-k', '3', '--channels', '8',
       '--max-channels', '16', '--style-dim', '16', '--map-num-layers', '2']
SG3 = ['--num-layers', '4', '--channels', '8', '--max-channels', '32', '--style-dim', '16',
       '--latent-dim', '16', '--d-channels', '8', '--d-max-channels', '16', '--gp-every', '3']
RECIPES = {'StyleGAN2': (j_sg2, t_sg2, t_sg2, SG2), 'StyleGAN3': (j_sg3, t_sg3, t_sg3, SG3),
           'ADA': (j_ada, t_ada, t_sg3, SG3 + ['--ada-interval', '2'])}


class _TinyG(nn.Module):
    '''A stand-in for the JAX recipes' G (their eager init takes many seconds on a CPU):
    NHWC images from z, a 'moments' collection as StyleGAN3's, and (images,
    w) from StyleGAN2's.'''
    image_size: int
    pair: bool

    @nn.compact
    def __call__(self, z, train=False):
        w = nn.Dense(3)(z)
        if not self.pair:
            self.variable('moments', 'w_avg', jnp.zeros, (3,))
        shape = (z.shape[0], self.image_size, self.image_size, 3)
        images = jnp.broadcast_to(jnp.tanh(w)[:, None, None, :], shape)
        return (images, w) if self.pair else images


class _TinyD(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(1)(x.reshape(x.shape[0], -1))


def _tiny_models(pair):
    def build_models(args, compute_dtype):
        return _TinyG(args.image_size, pair), _TinyD()
    return build_models


def _recorders(monkeypatch, module, rec, side):
    '''`module.build_train_step` replaced by a builder whose steps record
    (step index, do_r1, do_pl) and advance the step.'''
    sig = inspect.signature(module.build_train_step)

    def build(*a, **k):
        bound = sig.bind(*a, **k)
        tag = (bound.arguments['do_r1'], bound.arguments.get('do_pl', False))
        if side == 'jax':
            def step(state, batch):
                rec.append((int(state['step']),) + tag)
                return dict(state, step=state['step'] + 1), {'g': jnp.float32(0.),
                                                             'd': jnp.float32(1.)}
        else:
            def step(state, real, draws=None):
                rec.append((state['step'],) + tag)
                state['step'] += 1
                return {'g': torch.zeros(()), 'd': torch.ones(())}
        return step
    monkeypatch.setattr(module, 'build_train_step', build)


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_recipe_variants_and_files_match_jax(name, dirs, monkeypatch):
    j_mod, t_mod, t_step_mod, flags = RECIPES[name]
    size = '16' if name == 'StyleGAN2' else '32'
    monkeypatch.setattr(j_accelerate.Accelerator, 'jit_step', lambda self, fn, **k: fn)
    monkeypatch.setattr(j_mod, 'build_models', _tiny_models(name == 'StyleGAN2'))
    monkeypatch.setenv('ANIMEFACE_PLATFORM', 'cpu')
    recs = {}
    for side, module, step_module, argument, dataset in (
            ('jax', j_mod, j_mod, j_argument, j_dataset),
            ('torch', t_mod, t_step_mod, t_argument, t_dataset)):
        rec = recs[side] = []
        _recorders(monkeypatch, step_module, rec, side)
        for iters, extra in ((7, []), (9, ['--resume', str(
                dirs / side / name / 'result' / 'checkpoint')])):
            parser = argument.get_default_parser()
            argv = [name, '--synthetic-data', '--num-images', '32', '--image-size', size,
                    '--batch-size', '8', '--max-iters', str(iters), '--save', '3',
                    '--no-bf16', '--log-file', os.devnull, *flags, *extra]
            monkeypatch.setattr('sys.argv', ['main.py', *argv])
            with warnings.catch_warnings():
                warnings.simplefilter('ignore')
                module.main(parser)
    assert recs['jax'] == recs['torch']
    assert [r[0] for r in recs['torch']] == list(range(7)) + [7, 8]
    assert any(r[1] for r in recs['torch'])
    if name == 'StyleGAN2':
        assert any(r[2] for r in recs['torch'])
    assert _tree(dirs / 'jax') == _tree(dirs / 'torch')
