'''BigGAN (with `--ema` and `--deep`) and SEBigGAN through the port's CLI on
the CPU, end to end (tests/test_torch_runtime_cli.py's pattern, at 32px,
batch 8, f32, channels 4, z 16), then `--resume`: the sample grids of 16
images 4 to a row, `G_<step>.pt` equal to G_ema's state, the checkpoints
with both runs' losses, and the step count going on from the checkpoint.'''

import torch

from test_torch_runtime_cli import run_cli
from test_torch_runtime_cli_dcgan import check_run

FLAGS = ('--z-dim', '16', '--channels', '4')


def test_biggan_cli_trains_and_resumes(tmp_path):
    out = run_cli(tmp_path, 'BigGAN', 4, 2, 6, flags=FLAGS + ('--ema', '--deep'))
    state, losses = check_run(out, 4, 2, 6, 'G_ema', num_test=16, nrow=4)
    assert set(state) == {'G', 'D', 'G_ema', 'g_opt', 'd_opt', 'run'}
    assert sorted(losses) == ['d', 'g']
    assert any(k.startswith('blocks.0.cn1.') for k in state['G'])
    assert not all(state['G_ema'][k].equal(v) for k, v in state['G'].items())


def test_sebiggan_cli_trains_and_resumes(tmp_path):
    out = run_cli(tmp_path, 'SEBigGAN', 4, 2, 6, flags=FLAGS)
    state, losses = check_run(out, 4, 2, 6, 'G_ema', num_test=16, nrow=4)
    assert set(state) == {'G', 'D', 'G_ema', 'g_opt', 'd_opt', 'run'}
    assert sorted(losses) == ['d', 'g']
    assert 'attention.fc1.weight' in state['G']
    ema, g = state['G_ema'], state['G']
    assert not torch.equal(ema['blocks.0.cn1.running_var'], g['blocks.0.cn1.running_var'])
