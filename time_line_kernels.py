'''Device time alone of the ADA line-pass kernels of one checkout, so that
two checkouts' kernels can be compared in one call on one card:

    python3 time_line_kernels.py [TREE]

TREE (default: this checkout) is the root of the checkout whose
`animeface_tpu_torch` is timed; the inputs and the timing are this
checkout's `chip_smoke.py` helpers: both 128px pass shapes (batch 32) with
the main path's draws. For each pass it prints the forward's and the
backward's device time a call, the sum of every kernel a call launches
under torch.profiler over 10 back-to-back calls, and the CUDA-event time
of back-to-back calls with whether the host or the device bounds them. Run
it on two checkouts in turns (A, B, B, A): sub-millisecond kernels spread
10-30% between calls. Needs one CUDA card; imports nothing of JAX.
'''

import importlib.util
import sys
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent


def main() -> int:
    if not torch.cuda.is_available():
        print('time_line_kernels: no CUDA device', file=sys.stderr)
        return 1
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(tree))          # the timed package, before this checkout's
    spec = importlib.util.spec_from_file_location('chip_smoke', HERE / 'chip_smoke.py')
    s = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(s)
    from animeface_tpu_torch import _build
    from animeface_tpu_torch.nnutils import ada_geometry_cuda as agc

    print(f'{s._card_line()}; timing {agc.__file__}')
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build_all()
    dev = torch.device('cuda')
    passes = s._line_pass_inputs(*s._warp_draws(dev, s.ADA_IMAGE, seed=2))
    every = (('every kernel', ''),)
    total = {'fwd': 0.0, 'bwd': 0.0}
    for k, (z, t, f, M) in enumerate(passes, 1):
        N = z.shape[2]
        g = s._line_grad(z, M, seed=k)
        total['fwd'] += s._time_alone(f'{tree.name} ada_linepass_fwd pass {k}',
                                      lambda: agc._launch_line_fwd(z, t, f, M), every)
        total['bwd'] += s._time_alone(f'{tree.name} ada_linepass_bwd pass {k}',
                                      lambda: agc._launch_line_bwd(g, t, f, M, N), every)
    print(f'{tree.name} line kernels alone, both passes: forward {total["fwd"]:.4f} ms, '
          f'backward {total["bwd"]:.4f} ms of device time a warp')
    return 0


if __name__ == '__main__':
    sys.exit(main())
