'''Device time alone of the fused filtered_lrelu kernel of one checkout, so
that two checkouts' kernels can be compared in one call on one card:

    python3 time_flrelu_kernel.py [TREE]

TREE (default: this checkout) is the root of the checkout whose
`animeface_tpu_torch` is timed; the inputs and the timing are this
checkout's `chip_smoke.py` helpers (`_flrelu_inputs`, `_time_alone`): the
four StyleGAN3-256 same-resolution shapes (B = 16, bf16, 12-tap Hann
filters, padding 11, clamp 256). For each shape it prints the kernel's
device time a call under torch.profiler over 10 back-to-back calls, and
the CUDA-event time of back-to-back calls with whether the host or the
device bounds them; then their sum. A freshly built kernel's ptxas lines
(registers, spills) come first. Run it on two checkouts in turns
(A, B, B, A). Needs one CUDA card; imports nothing of JAX.
'''

import importlib.util
import sys
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parent


def main() -> int:
    if not torch.cuda.is_available():
        print('time_flrelu_kernel: no CUDA device', file=sys.stderr)
        return 1
    tree = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else HERE
    sys.path.insert(0, str(tree))          # the timed package, before this checkout's
    spec = importlib.util.spec_from_file_location('chip_smoke', HERE / 'chip_smoke.py')
    s = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(s)
    from animeface_tpu_torch import _build
    from animeface_tpu_torch.ops import cuda_kernels as ck
    from animeface_tpu_torch.ops import setup_filter

    print(f'{s._card_line()}; timing {ck.__file__}')
    for line in _build.build_all().get('filtered_lrelu', '').splitlines():
        if 'entry function' in line or 'registers' in line or 'spill' in line:
            print(f'  ptxas: {line.strip()}')
    dev = torch.device('cuda')
    fu = setup_filter(np.hanning(12), device=dev)
    pad = (s.FLRELU_PAD,) * 4
    total = 0.0
    for label, x, b in s._flrelu_inputs(dev)[:len(s.FLRELU_LAYERS)]:
        total += s._time_alone(f'{tree.name} {label}', lambda: ck.filtered_lrelu(
            x, fu, fu, b, pad, float(np.sqrt(2)), 0.2, s.FLRELU_CLAMP), s.FLRELU_PARTS)
    print(f'{tree.name} filtered_lrelu alone, the four path shapes: {total:.4f} ms of device '
          'time')
    return 0


if __name__ == '__main__':
    sys.exit(main())
