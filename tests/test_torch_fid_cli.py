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


def _trend_model(result_dir, model, *extra):
    with pytest.raises(SystemExit) as e:
        fid_trend.main(['--result-dir', str(result_dir), '--model', model, *FLAGS, *extra])
    return e.value.code


def _trend(result_dir, *extra):
    return _trend_model(result_dir, 'StyleGAN2', *extra)


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
    with pytest.raises(SystemExit) as e:                # PGGAN does not grow to 12px
        fid_trend.main(['--result-dir', str(tmp_path), '--model', 'PGGAN', *FLAGS,
                        '--image-size', '12'])
    assert e.value.code == 2
    assert 'PGGAN grows to [4, 8, 16, 32, 64, 128], not 12px' in capsys.readouterr().err


#: PGGAN snapshots in the progressive runtime's format: (step, sidecar)
PGGAN_SNAPSHOTS = ((10, dict(resolution=8, depth=1, mode='t', alpha=0.25)),
                   (20, dict(resolution=16, depth=2, mode='s', alpha=1.0)),
                   (30, None))


def test_fid_trend_pggan_reads_sidecars(tmp_path, capsys, on_cpu):
    '''`--model PGGAN` on snapshots saved as the PGGAN runtime saves them
    (`G_<step>.pt` of G at the run's full depth, beside it the sidecar
    `G_<step>.json`, one left without): each is sampled at its sidecar's
    depth, mode and alpha and resized up to --image-size (at full depth,
    's', alpha 1 without one), and `trend.json` records its resolution and
    alpha. (A CLI run small enough for this file is at 8px, below the
    trend's VGG: its five poolings need 16px.)'''
    from animeface_tpu_torch.implementations.PGGAN.model import Generator
    for step, sidecar in PGGAN_SNAPSHOTS:
        G = Generator(latent_dim=16, max_depth=2, generator=torch.Generator().manual_seed(step))
        save_model(str(tmp_path / f'G_{step}.pt'), G.state_dict())
        if sidecar:
            (tmp_path / f'G_{step}.json').write_text(json.dumps(sidecar))
    code = _trend_model(tmp_path, 'PGGAN', '--latent-dim', '16')
    report = json.loads((tmp_path / 'trend.json').read_text())
    assert code == (0 if report['gate_ok'] else 1)
    assert [{k: r.get(k) for k in ('step', 'resolution', 'alpha')} for r in report['results']] \
        == [dict(step=10, resolution=8, alpha=0.25), dict(step=20, resolution=16, alpha=1.0),
            dict(step=30, resolution=None, alpha=1.0)]
    assert all(math.isfinite(r['fd']) for r in report['results'])
    out = capsys.readouterr().out
    assert '8px alpha 0.25' in out and out.count('16px alpha 1.00') == 2

    args = fid_trend.parse_args(['--result-dir', str(tmp_path), '--image-size', '16',
                                 '--latent-dim', '16', '--batch-size', '2'])
    G, sample = fid_trend.pggan_model(args, torch.device('cpu'))
    images = sample(torch.Generator().manual_seed(1), dict(depth=1, mode='t', alpha=0.25))
    z = torch.randn((2, 16), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        low = G(z, 1, 't', 0.25)
    assert low.shape == (2, 3, 8, 8) and images.shape == (2, 3, 16, 16)
    assert torch.equal(images, torch.nn.functional.interpolate(
        low, size=(16, 16), mode='bilinear', align_corners=False))
