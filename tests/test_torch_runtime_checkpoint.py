'''The port's checkpoints: the directory's bookkeeping after the JAX
tests (tests/test_infra.py: retention, latest step, the sweep of orphaned
staging directories, a shape mismatch fatal, a missing or extra key
printed and filled or dropped), and on small StyleGAN2 and ADA runs
(the widths of tests/test_implementations.py): a restore into a run built
from another seed gives back every tensor, optimizer state and generator
state bitwise, and k steps, a save, a fresh build, a restore and n - k
steps end bitwise where n steps straight end, fed the same batches.'''

import os

import numpy as np
import pytest
import torch

from animeface_tpu_torch.checkpoint import (
    Checkpointer, load_model, save_model, snapshot, tensors)
from animeface_tpu_torch.implementations.ADA import utils as t_ada
from animeface_tpu_torch.implementations.StyleGAN2 import utils as t_sg2
from animeface_tpu_torch.nnutils.training import train_state


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among
    which a full thread pool per process spins many times slower.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_checkpointer_keeps_the_newest_and_finds_the_latest(tmp_path):
    ck = Checkpointer(str(tmp_path), max_to_keep=2)
    state = {'w': torch.arange(6.0).reshape(2, 3), 'step': 7}
    ck.save(7, state, meta={'status': {'batches_done': 7}})
    ck.save(14, state)
    ck.save(21, state)
    assert ck.all_steps() == [14, 21] and ck.latest_step() == 21
    target = {'w': torch.zeros(2, 3), 'step': 0}
    _, meta = ck.restore(target, step=14)
    assert torch.equal(target['w'], state['w']) and target['step'] == 7 and meta == {}


def test_orphaned_staging_dirs_are_swept(tmp_path):
    (tmp_path / '.tmp-ckpt-dead').mkdir()
    (tmp_path / '.tmp-ckpt-dead' / 'state.pt').write_bytes(b'partial')
    ck = Checkpointer(str(tmp_path))
    assert os.listdir(tmp_path) == [] and ck.latest_step() is None
    with pytest.raises(FileNotFoundError):
        ck.restore({})


def test_shape_mismatch_is_fatal(tmp_path):
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {'w': torch.zeros(2, 2), 'm': torch.nn.Linear(2, 2)})
    with pytest.raises(ValueError, match='shape'):
        ck.restore({'w': torch.zeros(3, 3), 'm': torch.nn.Linear(2, 2)})
    with pytest.raises(ValueError, match='shape'):
        ck.restore({'w': torch.zeros(2, 2), 'm': torch.nn.Linear(3, 2)})


def test_missing_key_filled_and_extra_dropped_loudly(tmp_path, capsys):
    ck = Checkpointer(str(tmp_path))
    ck.save(5, {'ada': {'p': torch.tensor(0.3), 'signsum': torch.tensor(1.0),
                        'legacy': torch.tensor(9.0), '_interval': 4}, 'step': 5})
    target = {'ada': {'p': torch.tensor(0.0), 'signsum': torch.tensor(0.0),
                      'count': torch.tensor(0.0), '_interval': 8}, 'step': 0}
    ck.restore(target)
    assert float(target['ada']['p']) == pytest.approx(0.3)
    assert float(target['ada']['count']) == 0.0           # kept from the built state
    assert 'legacy' not in target['ada']
    assert target['ada']['_interval'] == 8                 # configuration: from args
    assert target['step'] == 5
    out = capsys.readouterr().out
    assert 'MIGRATED' in out and 'count' in out and 'legacy' in out

    ck.save(6, {'m': torch.nn.Linear(2, 2)})
    m = torch.nn.Linear(2, 2, bias=False)
    ck.restore({'m': m})
    assert 'obsolete leaf in file dropped: /m/bias' in capsys.readouterr().out


def test_save_load_model(tmp_path):
    a, b = torch.nn.Linear(3, 2), torch.nn.Linear(3, 2)
    save_model(str(tmp_path / 'G_1.pt'), a.state_dict())
    load_model(str(tmp_path / 'G_1.pt'), b)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))


# ------------------------------------------------------------ training runs

B, S = 8, 32
SG2 = dict(image_size=S, batch_size=B, no_bf16=True, channels=8, max_channels=64, style_dim=32,
           map_num_layers=2, pl_lambda=2.0, d_k=3, g_k=2)
ADA = dict(image_size=S, batch_size=B, no_bf16=True, num_layers=4, channels=8, max_channels=32,
           style_dim=32, latent_dim=32, d_channels=8, d_max_channels=32, gp_every=2,
           ada_interval=1, ada_target_kimg=1)
RECIPES = {'StyleGAN2': (t_sg2, SG2, 6, 3), 'ADA': (t_ada, ADA, 4, 2)}


def _batches(n):
    g = torch.Generator().manual_seed(11)
    return [torch.rand((B, 3, S, S), generator=g) * 2 - 1 for _ in range(n)]


def _build(name, seed):
    module, kw, _, _ = RECIPES[name]
    return module.build_training(module.default_args(**kw), device='cpu', seed=seed)


def _steps(run, batches):
    for real in batches:
        run.train_step(run.state, real)


def _flat(state):
    out = {}

    def walk(tree, prefix):
        if isinstance(tree, torch.Tensor):
            out[prefix] = tree
        elif isinstance(tree, dict):
            for k, v in tree.items():
                walk(v, f'{prefix}/{k}')
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                walk(v, f'{prefix}/{i}')
        else:
            out[prefix] = tree
    walk(snapshot(state), '')
    return out


def _assert_equal(got, want):
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and torch.equal(g, w), k
        else:
            assert g == w, k


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_restore_into_another_seed_is_bitwise(name, tmp_path):
    run = _build(name, 0)
    _steps(run, _batches(3))
    state = train_state(run)
    Checkpointer(str(tmp_path)).save(3, state)
    other = _build(name, 1)
    assert not torch.equal(next(other.G.parameters()), next(run.G.parameters()))
    restored = train_state(other)
    Checkpointer(str(tmp_path)).restore(restored)
    _assert_equal(restored, state)
    if name == 'ADA':   # the controller's configuration comes from the arguments
        assert other.state['ada']['_interval'] == ADA['ada_interval']
    assert any(t.is_floating_point() for t in tensors(snapshot(restored['g_opt'])))


@pytest.mark.parametrize('name', sorted(RECIPES))
def test_split_and_resumed_run_is_bitwise(name, tmp_path):
    _, _, n, k = RECIPES[name]
    batches = _batches(n)
    straight = _build(name, 0)
    _steps(straight, batches)

    first = _build(name, 0)
    _steps(first, batches[:k])
    Checkpointer(str(tmp_path)).save(k, train_state(first))
    second = _build(name, 5)
    Checkpointer(str(tmp_path)).restore(train_state(second))
    assert second.state['step'] == k
    _steps(second, batches[k:])
    _assert_equal(train_state(second), train_state(straight))
    if name == 'StyleGAN2':
        assert [second.variant(i) for i in range(k, n)] == \
            [(i % 3 == 0, i % 2 == 0) for i in range(k, n)]
    else:
        assert float(straight.state['ada']['p']) > 0
    assert np.isfinite(float(straight.state.get('pl_mean', torch.zeros(()))))
