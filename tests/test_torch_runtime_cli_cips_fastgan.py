'''CIPS and FastGAN through the port's CLI on the CPU, end to end
(tests/test_torch_runtime_cli.py's pattern, at 32px, batch 8, f32, small
widths), then `--resume`: the artifacts, `G_<step>.pt` equal to G_ema's
state (FastGAN with `--ema`), and FastGAN's `recon.jpg`, the
reconstructions' grid 8 to a row. CIPS samples under impl 'cuda', which on
the CPU's tensors takes `bias_act`'s plain version. FastGAN runs with PIL
importable, which `.jpg` files need.'''

from test_torch_runtime_cli import BLOCKED, run_cli
from test_torch_runtime_cli_dcgan import check_run, grid_size

CIPS_FLAGS = ('--num-layers', '2', '--latent-dim', '16', '--style-dim', '16', '--g-channels',
              '8', '--g-max-channels', '16', '--d-channels', '8', '--d-max-channels', '16',
              '--gp-every', '3')
FASTGAN_FLAGS = ('--latent-dim', '8', '--g-channels', '4', '--g-max-channels', '16',
                 '--d-channels', '4', '--d-max-channels', '16', '--init-down-size', '32',
                 '--decoder-image-size', '16', '--ema')


def test_cips_cli_trains_and_resumes(tmp_path):
    out = run_cli(tmp_path, 'CIPS', 4, 2, 6, flags=CIPS_FLAGS)
    state, _ = check_run(out, 4, 2, 6, 'G_ema', num_test=16, nrow=4)
    assert set(state) == {'G', 'D', 'G_ema', 'g_opt', 'd_opt', 'run'}
    assert 'map.w_avg' in state['G_ema'] and float(state['G_ema']['map.w_avg'].abs().sum()) > 0


def test_fastgan_cli_writes_recon_grids_and_resumes(tmp_path):
    from PIL import Image

    out = run_cli(tmp_path, 'FastGAN', 4, 2, 6, flags=FASTGAN_FLAGS,
                  blocked=tuple(m for m in BLOCKED if m != 'PIL'))
    state, _ = check_run(out, 4, 2, 6, 'G_ema', num_test=16, nrow=4)
    assert set(state) == {'G', 'D', 'G_ema', 'g_opt', 'd_opt', 'run'}
    assert any(k.endswith('running_var') for k in state['G_ema'])
    assert not all(state['G_ema'][k].equal(v) for k, v in state['G'].items())
    with Image.open(out / 'recon.jpg') as grid:    # 4 sets of 8 reconstructions at 16px
        assert grid.size == grid_size(4 * 8, 8, 16)
    assert (out / 'running.jpg').exists()
