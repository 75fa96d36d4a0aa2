'''The StyleGAN3 recipe through the port's CLI on the CPU, end to end
(tests/test_torch_runtime_cli.py's pattern): 4 steps at the widths of
tests/test_implementations.py, then `--resume` to 6.'''

from test_torch_runtime_cli import SG3_FLAGS, check_artifacts, run_cli


def test_stylegan3_cli_trains_and_resumes(tmp_path):
    out = run_cli(tmp_path, 'StyleGAN3', 4, 2, 6, flags=SG3_FLAGS)
    state = check_artifacts(out, 4, 2, 6)
    assert any(k.endswith('magnitude_ema') for k in state['G_ema'])
