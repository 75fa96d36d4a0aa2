'''The port's FID CLI and trend gate (`python -m
animeface_tpu_torch.metrics.fid_cli` and `.fid_trend`) in-process on the
CPU, on tiny StyleGAN2 snapshots written with `save_model`.'''

import json
import math
import os

import numpy as np
import pytest
import torch

from animeface_tpu_torch.checkpoint import save_model
from animeface_tpu_torch.convert_weights import inception_npz
from animeface_tpu_torch.implementations.StyleGAN2.model import Generator
from animeface_tpu_torch.metrics import fid_cli, fid_trend
from animeface_tpu_torch.metrics.inception import WEIGHTS_ENV, InceptionV3Features


@pytest.fixture(autouse=True, scope='module')
def one_thread():
    '''One intra-op thread: the suite runs in parallel workers, among
    which a full thread pool per process spins many times slower.'''
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WIDTHS = dict(style_dim=16, channels=8, max_channels=16)
FLAGS = ['--image-size', '16', '--synthetic-data', '--num-samples', '8', '--batch-size', '4',
         '--style-dim', '16', '--channels', '8', '--max-channels', '16']


def _snapshot(path, seed, map_num_layers=8):
    G = Generator(image_size=16, map_num_layers=map_num_layers,
                  generator=torch.Generator().manual_seed(seed), **WIDTHS)
    save_model(str(path), G.state_dict())


@pytest.fixture
def on_cpu(monkeypatch):
    monkeypatch.setenv('ANIMEFACE_PLATFORM', 'cpu')


def test_fid_cli_prints_fid_and_kid(tmp_path, monkeypatch, capsys, on_cpu):
    torch.manual_seed(0)
    np.savez(tmp_path / 'inception.npz', **inception_npz(InceptionV3Features().state_dict()))
    monkeypatch.setenv(WEIGHTS_ENV, str(tmp_path / 'inception.npz'))
    _snapshot(tmp_path / 'G_3.pt', seed=3, map_num_layers=2)
    out = fid_cli.main(['--weights', str(tmp_path / 'G_3.pt'), '--map-num-layers', '2',
                        '--kid', *FLAGS])
    lines = capsys.readouterr().out.splitlines()
    fid_line = [ln for ln in lines if ln.startswith('FID-0k: ')]
    kid_line = [ln for ln in lines if ln.startswith('KID-0k: ')]
    assert len(fid_line) == len(kid_line) == 1, lines
    assert fid_line[0] == f'FID-0k: {out["fid"]:.4f}'
    assert kid_line[0] == f'KID-0k: {out["kid"]:.6f}'
    assert math.isfinite(out['fid']) and math.isfinite(out['kid'])


def test_fid_cli_refuses_without_card(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv('ANIMEFACE_PLATFORM', raising=False)
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(SystemExit) as e:
        fid_cli.main(['--weights', str(tmp_path / 'G_1.pt'), *FLAGS])
    assert e.value.code == 1
    assert 'no CUDA device' in capsys.readouterr().err


def _trend(result_dir, *extra):
    with pytest.raises(SystemExit) as e:
        fid_trend.main(['--result-dir', str(result_dir), '--model', 'StyleGAN2', *FLAGS,
                        *extra])
    return e.value.code


def test_fid_trend_gate_and_exit_codes(tmp_path, capsys, on_cpu):
    '''Two snapshots scored in both orders: the gate passes (exit 0) in one
    and fails (exit 1) in the other, as `trend.json` says.'''
    _snapshot(tmp_path / 'G_10.pt', seed=1)
    _snapshot(tmp_path / 'G_20.pt', seed=2)
    codes, fds = [], []
    for swap in (False, True):
        if swap:
            os.replace(tmp_path / 'G_10.pt', tmp_path / 'tmp.pt')
            os.replace(tmp_path / 'G_20.pt', tmp_path / 'G_10.pt')
            os.replace(tmp_path / 'tmp.pt', tmp_path / 'G_20.pt')
        codes.append(_trend(tmp_path))
        with open(tmp_path / 'trend.json') as f:
            report = json.load(f)
        assert [r['step'] for r in report['results']] == [10, 20]
        assert all(math.isfinite(r['fd']) for r in report['results'])
        assert report['gate_ok'] == (codes[-1] == 0)
        assert report['gate_ok'] == (report['results'][1]['fd'] < report['results'][0]['fd'])
        fds.append([r['fd'] for r in report['results']])
    assert sorted(codes) == [0, 1]
    assert fds[1] == fds[0][::-1]        # a snapshot's fd does not depend on its step
    out = capsys.readouterr().out
    assert out.count('[trend] step') == 4 and '[trend] gate OK' in out
    assert '[trend] gate FAILED' in out


def test_fid_trend_refusals(tmp_path, on_cpu, capsys):
    _snapshot(tmp_path / 'G_10.pt', seed=1)
    assert _trend(tmp_path) == 2                        # one snapshot
    assert 'need >= 2 numbered snapshots' in capsys.readouterr().err
    _snapshot(tmp_path / 'G_20.pt', seed=2)
    with pytest.raises(NotImplementedError, match='Queue 1 item 8'):
        fid_trend.main(['--result-dir', str(tmp_path), '--model', 'PGGAN', *FLAGS])
