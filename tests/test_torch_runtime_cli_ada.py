'''The ADA recipe through the port's CLI on the CPU, end to end
(tests/test_torch_runtime_cli.py's pattern): 4 steps at the widths of
tests/test_implementations.py with the controller updating every 2 steps,
then `--resume` to 6; the controller's state is in the checkpoint.'''

from test_torch_runtime_cli import SG3_FLAGS, check_artifacts, run_cli


def test_ada_cli_trains_and_resumes(tmp_path):
    out = run_cli(tmp_path, 'ADA', 4, 2, 6,
                  flags=SG3_FLAGS + ('--ada-interval', '2', '--ada-target-kimg', '1'))
    state = check_artifacts(out, 4, 2, 6)
    ada = state['run']['ada']
    assert set(ada) == {'p', 'signsum', 'count', 'num_iter'}
    assert 0.0 <= float(ada['p']) <= 1.0
